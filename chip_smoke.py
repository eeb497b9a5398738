#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dair_pll_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX and nothing of
the JAX package, needs one CUDA card, and exits with a non-zero code,
printing no result, when there is none or when the port is not beside it.
Phases, in this order, each of which raises on failure and reports its
seconds. Every phase whose rate the host bounds (the eager rollouts, the
ICNN training step) runs before the first ``torch.profiler`` trace: on
the H100 a trace leaves later kernel launches in the process 10-30%
slower (PERF.md).

1. Device: the card's name and power limit as ``nvidia-smi`` reports them.
   Build: every kernel of ``dair_pll_tpu_torch/csrc/`` into one library,
   with ``ptxas``'s register and spill report.
2. Solve kernel against plain version (K5, ``csrc/warm_hybrid_solve.cuh``,
   at the cube's (n_v, k) = (6, 4) on 4 lanes a QP): the contact QPs of a
   cube rollout step at 8,192 samples with the rollout budget (14, 6), eps
   = 1e-4, their first 8,191 and 1,001 (ragged batches, groups past the
   end), and 65,536 (where float32 runs one thread a QP): in float64
   against the plain PyTorch version on the card,
   bit for bit, and in float32 against the plain float32 version, with the
   samples where the two differ decided against the plain float64 result.
   Times the kernel and the plain version with CUDA events and computes
   the kernel's bound in each type from the bytes it moves and the
   operations its own body needs on these QPs (counted on the host, as
   for the elbow's K5 in phase 11), with the share of QPs with contact and
   ptxas's lines in both types.
3. Rollouts: ``MultibodyLearnableSystem.from_urdfs(cube)`` on the card,
   ``simulate_batch`` over 8,192 trajectories x 128 steps in float32 (the
   simulation-bench shape of the JAX package), with K5's launch count read
   around that run alone; the first 10 steps of 8 trajectories rerun in
   float64 on the card and on the CPU must agree. Then a breakdown of one
   step's time into terms, solve and update.
4. Cold solve kernel against plain version (K4, ``csrc/cold_hybrid_solve.cuh``)
   on the deep-support (ICNN) cube's cold loss QPs at 8,192 samples of its
   own float64 rollout, (10, 10) at eps = 1e-3: float64 within 1e-9 (1 +
   |plain|) with equal valid masks and bit for bit, float32 by the K5
   rule; the same at the ICNN training batch of 262,144, on the QPs the
   training step's cold loss hands K4 (float32, and the same cast to
   float64), against the plain version run over chunks. Then its times at
   the training batch (float32 and float64), the plain version's at
   8,192, its bound in each type from the operations its own body needs
   (counted on the host on the first COUNT_B QPs, scaled), the shares of
   its IPM and Newton iterations that were exact fixed points (where it
   leaves the loop), its design and ptxas's lines.
   Then the ICNN cube's cold and warm loss in float64 on 16 transitions
   (8 of the training batch, 8 rollout steps in contact), with every
   leaf's gradient, on the card (K4, K5) against the CPU at the same
   parameters, at the CPU loss tests' bars.
5. ICNN rollouts: ``from_urdfs(cube_mesh)`` (depth 2, width 256, 4
   witness queries), 8,192 trajectories x 32 steps in float32 (K5), and
   the first 10 steps of 8 trajectories in float64 on the card and on the
   CPU.
6. The vmapped stack and the APGD cone-solve kernel (K6,
   ``csrc/apgd_cone_solve.cuh``, a group of 8, 16 or 32 lanes a problem):
   K6 against its plain version on 8,192 problems each of the cube's
   vmapped loss QPs (k = 4) and random PSD problems at k = 1, 4 and 9,
   and on the random problems at 65,535 and 1,001 (ragged batches),
   float64 within 1e-9 (1 + |plain|) with equal valid masks, float32 by
   the K5 rule; its times at 65,536 (the batch the K6 route's training
   step hands it) and 262,144 cube loss QPs (float32 and float64), the
   plain version's at 8,192, its bound and ptxas's lines for it; the
   share of diverged solutions (not finite or above 1e3) from K6 and its
   plain version in float32 and float64 on 65,536 random k = 4 problems
   at the recipe's ridge and at 1e-4. Then the box cube's vmapped training
   step at the reference recipe's batch of 256 (the default route: the
   hybrid solve in plain PyTorch, no kernel) and on the APGD kernel route
   at 256 and 65,536 (one K6 launch a step), 8 steps each; K6 on the
   65,536 problems that step hands it (captured at its wrapper) against
   the plain version over chunks; the vmapped loss (hybrid and K6 routes)
   with every leaf's gradient, the vmapped rollout and the IFT gradient
   of a rollout loss in float64 on the card against the CPU, for the box
   and the ICNN cube; and the box cube's vmapped rollout of 256 x 32
   steps with one gradient through it. Last of all (11.), a
   ``torch.profiler`` trace of one vmapped training step on each route.
7. ICNN training, float32, 262,144 transitions of the training recipe: a
   cold step (plain terms under autograd, K4), the cache's seed (K5) and 8
   epoch-warm steps (K5), Adam on every leaf; a warm-up round and a timed
   round with the launch counts; one step at the reference recipe's batch
   of 256 (``use_fused=True``); a URDF export of the trained shape; a
   ``torch.profiler`` trace of one warm step.
8. The box cube's rollout step from a ``torch.profiler`` trace: the
   kernels on the card per step.
9. Loss kernels against plain versions (K1, K3, K2,
   ``csrc/contactnets_loss.cuh``) on 8,192 cube transitions of the port's
   own float64 rollout: K1 (cold, (10, 10)) and K3 (warm, (4, 10), from
   K1's impulses at parameters one Adam step on) in float64 within 1e-9
   (1 + |plain|) with equal valid masks, K2 against the plain autograd
   backward within rtol 1e-6, atol 1e-9 and bit for bit from run to run;
   in float32 the K5 rule for loss and impulses, and K2's batch gradient
   no further from the float64 plain result than twice the plain float32
   version's. Then their times at the training shape (float32, 2,097,152
   samples; K2, one reverse-mode adjoint sweep per sample, also in
   float64, with ptxas's register and spill lines for its kernel), the
   plain versions' at 8,192, and their bounds from the operations their
   own code needs on this batch, counted on the host with ``g++``'s build
   of the same code (K1's and K3's on the first COUNT_B samples, scaled);
   K1 and K3 also in float64 and at each budget of SOLVE_BUDGETS, with the
   split into the terms, an IPM and a Newton iteration, and ptxas's lines
   of the three in both types; the shares of K1's IPM and Newton
   iterations that were exact fixed points, where its solve leaves the
   loop, and its operations without those exits. Then the
   three kernels at the training shape against their plain versions run
   over chunks of the batch, K2 with the mean's cotangent 1/B.
10. Training: ``bench.py``'s workload on the card, float32, 2,097,152 cube
   transitions: a cold step (K1, K2, Adam), the seed of the impulse cache
   (the warm call from zeros at the cold budget, K3), then 8 epoch-warm
   steps at (4, 10) (K3, K2, Adam); a warm-up round and a timed round,
   with the launch counts read around the timed round; a
   ``torch.profiler`` trace of one warm step. The card bounds this step,
   so the earlier traces do not move it.
11. The elbow (``from_urdfs(elbow)``: a free base box, a revolute hinge,
   a second box; 15 states, 8 contacts) and the model-generic loss
   kernels. Before the first trace, after phase 6's rollout: K5 and K4 at
   the elbow's (n_v, k) = (7, 8) against their plain versions (K5 on
   8,192 QPs of the elbow's float64 rollout near the ground at (14, 6),
   K4 on 8,192 of the ICNN elbow's cold loss QPs at (10, 10)), float64
   within TOL64 (1 + |plain|) with equal masks (K5, on 4 lanes a QP, bit
   for bit), float32 by the K5 rule, with K5's times at 8,192 and its
   bound in both types from the operations its own body needs on these
   QPs (counted on the host), the share of QPs with contact, and ptxas's
   lines for both in both types; the elbow's
   rollout of 8,192 trajectories x 120 steps in float32 with K5's
   launches (float32 trajectories that leave the finite numbers, at most
   ELBOW_DIVERGED_SHARE, are rerun in float64 and must stay finite) and
   10 steps of 8 in float64 on the card against the CPU; the ICNN
   elbow's cold and warm loss at 65,536 transitions (K4, K5 at (7, 8)),
   K4 on the 65,536 QPs that loss hands it against its plain version
   over chunks (the same rules) with its times, own-count bound and
   fixed-point shares there, then the loss in float64 on 16 transitions
   with every leaf's gradient, card against CPU; then K4 on its
   contact-rich sets (the ICNN models' QPs at initial parameters have no
   contact): the QPs of the box cube's (6, 4) and the elbow's (7, 8)
   rollouts near the ground at 65,536 and 16,384, at (10, 10), against
   the plain version at 8,192, 8,191 and 1,001 and over chunks of the
   whole set (float64 bit for bit), its times, own-count bounds and
   fixed-point shares there. After phase 10: the generic K1, K3 and K2 against their
   plain versions on 8,192 transitions of the elbow's, the polygon
   elbow's and the polygon cube's own rollouts (phase 9's rules); their
   times at 2,097,152 elbow transitions (the cube's recipe carried to the
   elbow's 15 states; also in float64), K1's and K3's (the terms on one
   thread a sample, the solve on 4 lanes a sample) also at each (ipm,
   newton) budget of SOLVE_BUDGETS, split into the terms, an IPM
   iteration and a Newton iteration, bounds from the operations
   they need on the first COUNT_B samples, scaled (K1's and K3's own
   code's, ``ops/host_adjoint.py``'s counting build of
   ``csrc/model_terms.cuh``; K2's the smaller of its own reverse-mode
   sweep's, ``csrc/model_adjoint.cuh``, without the forward terms it
   computes a second time, and torch autograd's) and ptxas's
   lines for K1, K3 and K2 at both sizes and types,
   then against their plain versions over chunks of a 65,536 slice (the
   plain versions over the whole batch would take minutes a kernel); the
   elbow's training round (as phase 10, traced); the polygon cube's
   training round at 262,144 with its kernels' times (also in float64).
12. The experiment layer through the CLI's entry point
   (``dair_pll_tpu_torch.examples.contactnets_simple.run``), after phase
   11's host-bound phases and before the ICNN training's trace, in a fresh
   ``build/experiment_smoke/``; videos off (``video_period=0``: the card's
   machine has no matplotlib). ``experiment_card_vs_cpu``: 32 tosses of
   20 states generated on the CPU, a seed and a warm epoch of the box cube
   at batch 256 with float64 parameters, ``loss_dtype="float64"`` and
   ``force_fused_loss`` (K1, K3, K2 in float64) on the card and on the
   CPU, on copies of the storage: equal batch tables, each step's loss
   within rtol 1e-8, the parameters after each epoch within rtol 1e-5,
   atol 1e-9, the final evaluation's ``_mean`` statistics within rtol
   1e-6, K1/K3/K2 launches equal to the steps and loss batches. ``experiment``: the CLI's recipe (256 tosses
   of 40 states, half the CLI's (the tosses reach the ground from about
   the 27th), made with its generator before its call;
   batch 256, lr 1e-3) for 5 epochs, the learned system from
   ``assets.wrong_init_urdf("cube")`` (from the truth the loss cannot
   fall); per epoch the train loss, best valid loss, the seconds of
   training, evaluation and logging, train slices per second and K1, K2,
   K3, K5 launches, each held to what the steps, loss batches and
   evaluations need; the final ``_mean`` statistics; the learned mass,
   sides and friction beside the truth; a falling loss, finite
   parameters, the checkpoint and the re-exported URDF; then the same
   call again, which must generate nothing and resume. No per-epoch
   evaluation, only the final one (the CLI's default is every epoch; each
   costs about 21 s of vmapped rollouts, which the script's time limit
   cannot hold beside phase 13).
   ``experiment_mesh_elbow``: the same checks for
   ``--mesh`` (the ICNN cube, its warm loss on K5 and cold passes on K4;
   meshes in the summary and the export) and ``--system elbow`` (the
   generic K3/K2 and K1, from its wrong init; since PR 14 its tosses of
   60 states, half the CLI's, made before the call), 2 epochs each, 1,024
   tosses (fused rollouts) at batch 2,048, no per-epoch evaluation. ``experiment_scale``: 8,192 tosses (the fused rollout on K5),
   batch 16,384, 10 epochs (a warm reseed at epoch 9), epoch 8 traced (device busy share, top kernels,
   kernels per step). After them, ``sharded_experiment`` (phase 14).
14. Every model size the TPU kernels take, after phase 11's ``k4_contact_rich``:
   ``size_cover`` (each instantiation built at first use, in ``build``):
   a ball ((n_v, k) = (6, 1)) and a box and a sphere on one body (witnesses
   4 + 1, (6, 5)), each with its generic K1, K3 and K2 against their plain
   versions on 8,192 transitions of its own float64 rollout (phase 9's
   rules), K5 on its rollout QPs against plain (float64 within TOL64,
   float32 by the tail rule), a training round at 2,097,152 (a cold step,
   the seed and 8 warm steps, their launches), the fused rollout of 8,192
   x 128 (K5's launches; float32 trajectories that leave the finite
   numbers, at most SIZE_DIVERGED_SHARE, rerun in float64 must stay
   finite) and the kernels' times and own-count bounds; K4 at (6, 1) on the
   ball's cold loss through its plain terms at 262,144 against plain over
   chunks; a free body with a prism of 20 vertices (a polygon) and a
   sphere, whose K2 keeps its gradient in the thread's stack: its generic
   K1, K3 and K2 against plain as above; the three cubes (k = 15) on the
   K6 route, 8 steps at 65,536, K6
   against plain on those problems and on random ones, float64 and
   float32. ``sharded_experiment``: ``shard_training`` and
   ``shard_evaluation`` in worker processes of this script
   (``--sharded-worker``, each with a timeout): the float64 recipe of
   ``experiment_card_vs_cpu`` in two processes sharing the card over gloo
   and in one over NCCL at world size 1, against that phase's unsharded
   run (losses rtol 1e-4, parameters rtol 1e-6 atol 1e-10); then the
   production recipe of ``experiment_scale`` (8,192 tosses, batch 16,384)
   both ways, 2 epochs and an evaluation pass over 2,048 train tosses,
   with epoch seconds, slices/s and each rank's launches.
   ``--only-size-cover`` and ``--only-sharded`` run these alone after the
   build.
13. The baselines and the estimators, after phase 12 and before the ICNN
   training's trace, in a fresh ``build/baseline_smoke/``:
   ``baselines_card_vs_cpu`` (32 tosses of 20 states made on the CPU; one
   epoch at batch 256 in float64 of the deep MLP, the recurrent deep model
   with a history of 4 and the residual cube, on the card and on the CPU
   on copies of the storage: equal batch tables, each step's loss within
   rtol 1e-8, the parameters within rtol 1e-5, atol 1e-9; the manifold
   UKF and the JUKF filtering a linear system, states and covariances
   within rtol 1e-9); ``deep_baseline``
   (``examples/deep_learnable_baseline.py``'s recipe: 1,024 cube tosses of
   80 states on the fused rollout, K5 79 launches; the MLP and the
   recurrent model, hidden 128, 2 layers, batch 256, 3 epochs each, the
   final evaluation beside the cube on K5; per epoch the seconds and train
   slices/s; a falling loss, finite parameters, K5 launches equal to what
   generation and evaluation need, a rerun that resumes);
   ``residual_physics`` (``examples/residual_physics_cube.py``'s recipe:
   64 dragged tosses of 60 states on the vmapped integrator, the residual
   cube, hidden 64, 2 layers, scale 0.1, batch 256, 6 epochs, the final
   evaluation; seconds per epoch and
   ``residual_weight_norm``; a falling loss from the first trained epoch,
   both halves' leaves moved, no kernel). ``--only-baselines`` runs these
   three alone after the build. The MuJoCo paths are not driven: the
   card's machine has no ``mujoco``.

It prints, in this order: one JSON line per phase, the kernel table as
one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import math
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
#: The ContactNets loss: regularization, cold and warm (ipm, newton)
#: budgets, Adam's learning rate, the training batch and its warm steps
#: per round (``bench.py``: batch 2,097,152, ``SCAN_STEPS = 8``).
LOSS_EPS = 1e-3
COLD_BUDGET = (10, 10)
WARM_BUDGET = (4, 10)
LR = 1e-3
TRAIN_B = 2097152
WARM_STEPS = 8
#: K2 against the plain autograd backward in float64: the repo's gradient
#: bar (the kernel's hand-written adjoint and torch autograd take the same
#: derivatives, summed in other orders).
GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-9
#: K2's float32 batch gradient: its rel-l2 distance from the float64 plain
#: result at most this many times the plain float32 version's.
DP_FACTOR = 2.0
#: At the training shape, with both runs at the same impulses, the float32
#: gradients' rel-l2 from float64 is a few float32 ulps, and its ratio
#: measures the order of the sums, not the kernel: there the float32 rule
#: takes max(plain rel-l2, F32_GRAD_FLOOR), about 8 ulps, as the plain
#: version's. A block partial of K2 lost from the batch sum would still
#: move dp by some 1/16,384, 60 times this floor.
F32_GRAD_FLOOR = 1e-6
#: Samples per call when the plain versions run over the training batch:
#: the forward under ``no_grad`` holds a few hundred batch rows at once,
#: the backward every intermediate of the terms chain for autograd.
PLAIN_FWD_CHUNK = 524288
PLAIN_BWD_CHUNK = 131072
#: The deep-support (ICNN) cube: its training batch (ContactNets at a
#: quarter of the box cube's 2,097,152, since a (B 4, 256) float32
#: activation of its support points is 1 GiB), the reference recipe's
#: batch (``scripts/mesh_real_cube.py``, 256, below FUSED_LOSS_MIN_BATCH,
#: so ``use_fused=True``) and its rollout length.
ICNN_TRAIN_B = 262144
ICNN_REF_B = 256
ICNN_STEPS = 32
#: K4's plain version over the ICNN training batch runs on blocks of this
#: many samples.
ICNN_PLAIN_CHUNK = 65536
#: The ICNN loss on the card against the CPU, in float64: this many
#: training transitions, at the CPU loss tests' bars (loss rtol 1e-8,
#: atol 1e-12; gradients rtol GRAD_RTOL, atol 1e-10).
ICNN_CHECK_B = 16
LOSS_RTOL, LOSS_ATOL = 1e-8, 1e-12
CPU_GRAD_ATOL = 1e-10
#: The APGD kernel K6 (the vmapped loss's APGD route): its iterations
#: (the system's ``solver_iterations``), a second, larger timing batch
#: (the first is the main path's, VMAPPED_BIG_B), and the plain version's
#: block over the captured training problems.
APGD_ITERATIONS = 200
APGD_TIMING_B = 262144
APGD_PLAIN_CHUNK = 8192
#: The vmapped stack: the reference recipe's training batch
#: (``examples/contactnets_simple.py``, 256, below FUSED_LOSS_MIN_BATCH),
#: the K6 route's large batch, training steps per run, the card-against-
#: CPU transitions and the rollout's length.
VMAPPED_B = 256
VMAPPED_BIG_B = 65536
VMAPPED_STEPS = 8
VMAPPED_CHECK_B = 16
#: The vmapped rollout's steps: 16, half the 32 it ran before, so that the
#: script keeps to its time limit (``PERF.md`` §4).
VMAPPED_ROLLOUT_STEPS = 16
#: The elbow (``examples/contactnets_simple.py``: a free base box, a
#: revolute hinge, a second box; 15 states, 8 contacts): its trajectory
#: length, its training batch (the box cube's), the ICNN elbow's loss
#: batch, the slice of the training batch its kernels are held against
#: their plain versions on, and the samples the host counts each loss
#: kernel's operations on (scaled to the timed batch). The slice's 32,768
#: transitions are half what they were before, so that the script keeps to
#: its time limit (``PERF.md`` §4).
ELBOW_STEPS = 120
ELBOW_TRAIN_B = 2097152
ELBOW_ICNN_B = 65536
ELBOW_SLICE = 32768
ELBOW_PLAIN_CHUNK = 16384
#: Float32 elbow trajectories may leave the finite numbers over the 120
#: steps: float32 solves at eps = 1e-4 turn rounding into impulses that
#: throw a body, and the two-body chain can then spin up without bound.
#: The JAX package's float32 rollout does so too: on the CPU, over the
#: first 512 of these states, on 5 (0.98%), and the port's on 1
#: (``tests/test_torch_elbow_rollout.py``, the slow
#: ``test_float32_elbow_divergence_is_the_references``). The limit is the
#: reference's share, rounded up; each such trajectory must stay finite
#: in float64.
ELBOW_DIVERGED_SHARE = 0.01
COUNT_B = 8192
#: The polygon cube (the generic kernels' one-body size): its training
#: batch.
POLYGON_TRAIN_B = 262144
#: (ipm, newton) budgets at which the generic K1 and K3 are timed at the
#: elbow's training batch: the terms and assembly alone, then IPM and
#: Newton iterations (COLD_BUDGET and WARM_BUDGET among them).
SOLVE_BUDGETS = ((0, 0), (4, 0), (10, 0), (4, 10), (10, 10))
#: The models whose generic sizes the default host build holds
#: (``generic_models``); the others are ``size_cover``'s.
DEFAULT_HOST_MODELS = ("cube_polygon", "elbow", "elbow_polygon")
#: The generic K2's design at every size; each size's own choices follow
#: (``generic_design``).
BWD_DESIGN = "reverse-mode adjoint, one sweep per sample"


def design_text(design: dict, kind: str, k: int) -> str:
    """The words for a generic kernel's design (``kind`` K1, K3 or K2) of
    ``soa_loss_kernels.loss_design`` at a size of ``k`` contacts."""
    lanes = design["lanes"]
    if kind == "K2":
        parts = [BWD_DESIGN]
    elif lanes == 1:
        parts = ["one thread a sample"]
    else:
        parts = [f"terms on one thread a sample, then the solve on {lanes} "
                 f"lanes a sample ({k // lanes} contacts a lane)"]
    if design["const_body"]:
        parts.append("the free body's joint as constants")
    if kind == "K1" and design["cold_exits"]:
        parts.append("the cold solve leaves its IPM and Newton loops at "
                     "their exact fixed points, a warp together")
    if kind == "K2" and design["grad_shared"]:
        parts.append("each sample's derived-scalar gradient a column in "
                     "shared memory")
    return "; ".join(parts)


def generic_design(size: str, kind: str) -> str:
    """The generic K1's, K3's or K2's design (``kind``) at a size of
    :func:`generic_sizes`, as its built libraries give it
    (``soa_loss_kernels.loss_design``): float32's, and float64's after it
    where that differs."""
    import torch
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    model_size = {s.name: s for s in generic_sizes()}[size]
    k = sum(model_size.witnesses)
    f32, f64 = (design_text(lk.loss_design(model_size, dtype), kind, k)
                for dtype in (torch.float32, torch.float64))
    return f32 if f32 == f64 else f"{f32} (float64: {f64})"


#: The box cube's K1 and K3 (``csrc/contactnets_loss.cuh``).
CUBE_FWD_DESIGN = "one thread a sample"
CUBE_K1_DESIGN = ("one thread a sample; the cold solve leaves its IPM and "
                  "Newton loops at their exact fixed points")
#: K4's design at each size (``kColdLanes`` of ``csrc/hybrid_solve.cuh``;
#: ``kColdFewerFrom``, ``kColdIpmExits`` of ``csrc/cold_hybrid_solve.cuh``).
K4_EXITS = ("SAP-Newton leaves at its exact fixed point, a warp together; "
            "in float64 the IPM too")
K4_DESIGN = {
    "nv6_k4": "4 lanes a QP (one contact a lane), 64-thread blocks; from "
              "32,768 QPs one thread a QP in float32, 2 lanes in float64; "
              + K4_EXITS,
    "nv7_k8": "4 lanes a QP (two contacts a lane), 64-thread blocks; "
              + K4_EXITS}
#: K4's contact-rich sets: the QPs of the box cube's (6, 4) and the
#: elbow's (7, 8) fused rollouts near the ground, solved at the cold
#: loss's budget; since PR 14 a quarter of the main path's batches of K4
#: at each size (the ICNN cube's training batch of 262,144, the ICNN
#: elbow's loss batch of 65,536), so that the script keeps to its time
#: limit (``PERF.md`` §4).
K4_RICH_B = {"nv6_k4": 65536, "nv7_k8": 16384}
#: K5's design at the elbow's (n_v, k) = (7, 8) and the cube's (6, 4)
#: (``kWarmLanes`` of ``csrc/hybrid_solve.cuh``).
K5_DESIGN = "4 lanes a QP (two contacts a lane), 64-thread blocks"
CUBE_K5_DESIGN = ("4 lanes a QP (one contact a lane), 64-thread blocks; "
                  "one thread a QP in float32 from 32,768 QPs")
#: Ragged batches the cube's K5 is also held against its plain version at
#: (the first QPs of the rollout's), so that groups past the batch run;
#: and a batch of rollout QPs at which float32 runs one thread a QP
#: (``kWarmSoloFrom``), held and timed as well.
K5_RAGGED_B = (8191, 1001)
K5_LARGE_B = 65536
#: K6's design (``csrc/apgd_cone_solve.cuh``), and the ragged batches of
#: random problems it is held against its plain version at, one problem
#: per group width (k = 1, 4 and 9 on 8, 16 and 32 lanes).
K6_DESIGN = ("a group of 8, 16 or 32 lanes a problem (16 at k = 4), the "
             "iterate through shared memory")
K6_RAGGED_B = (65535, 1001)
#: Float32 APGD divergence: random k = 4 problems of the JAX package's
#: recipe (Q = A A' + ridge I) at this batch and ridges, the recipe's and
#: a worse-conditioned one; problems count as diverged when the solution
#: is not finite or exceeds 1e3 (the solve's failure mask). 262,144
#: problems until PR 14, cut to keep to the time limit (``PERF.md`` §4).
DIVERGENCE_B = 65536
DIVERGENCE_RIDGES = (0.1, 1e-4)
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


def phase_device() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    line = proc.stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": line})
    return line


class DeviceSampler:
    """The card's SM clock, temperature, power draw and the active clock
    event (throttle) reasons, sampled every second by one ``nvidia-smi``
    process for the whole run, which ``stop`` (or the interpreter's exit,
    a failed phase's included) ends; ``summary(t0, t1)`` sums up the
    samples of an interval of ``time.perf_counter()``."""

    FIELDS = ("clocks.sm,clocks.max.sm,temperature.gpu,power.draw,"
              "clocks_event_reasons.active",
              "clocks.sm,clocks.max.sm,temperature.gpu,power.draw,"
              "clocks_throttle_reasons.active")

    def __init__(self):
        import atexit
        import threading
        for fields in self.FIELDS:
            if subprocess.run(
                    ["nvidia-smi", f"--query-gpu={fields}",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=60).returncode == 0:
                break
        else:
            raise RuntimeError("nvidia-smi reads no clocks")
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits", "-lms", "1000"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        atexit.register(self.stop)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            try:
                values = [float(p) for p in parts[:4]]
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), *values, parts[4]))

    def summary(self, t0: float, t1: float) -> dict:
        got = [s for s in self.samples if t0 <= s[0] <= t1]
        if not got:
            return {"samples": 0}
        sm = [s[1] for s in got]
        return {"samples": len(got), "sm_mhz_min": min(sm),
                "sm_mhz_median": statistics.median(sm),
                "sm_mhz_max_rated": got[0][2],
                "temperature_c_max": max(s[3] for s in got),
                "power_w_max": max(s[4] for s in got),
                "clock_event_reasons": sorted({s[5] for s in got})}

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            self.proc.wait(timeout=60)


def kernel_instances() -> list:
    """Every kernel instantiation the script's phases launch: K5 and K4 at
    the cube's (6, 4), the elbow's (7, 8) and the ball's (6, 1), K5 at the
    box and sphere's (6, 5), K6 at k = 1, 4, 9 and 15, the box cube's K1-K3
    and the generic K1-K3 of the polygon cube, the elbow, the ball, the
    box and sphere body and the wide polygon, each in float32 and
    float64."""
    import torch
    from dair_pll_tpu_torch.ops import cone_kernels, soa_kernels
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    out = [lk.CUBE_INSTANCE]
    for dtype in (torch.float32, torch.float64):
        out += [soa_kernels.warm_instance(n_v, k, dtype)
                for n_v, k in ((6, 4), (7, 8), (6, 1), (6, 5))]
        out += [soa_kernels.cold_instance(n_v, k, dtype)
                for n_v, k in ((6, 4), (7, 8), (6, 1))]
        out += [cone_kernels.apgd_instance(k, dtype) for k in (1, 4, 9, 15)]
        for size in generic_sizes():
            out += lk.loss_instances(size, dtype)
    return out


def build_kernels() -> None:
    """Builds every instantiation the phases launch, all at once (one
    ``nvcc`` each), so that no phase's time holds a build."""
    from dair_pll_tpu_torch.ops import soa_kernels
    t0 = time.perf_counter()
    readings = soa_kernels.build_instances(kernel_instances())
    log = soa_kernels.build_log()
    ptxas = [ln.strip() for ln in log.splitlines()
             if any(key in ln for key in ("Function properties",
                                          "registers", "spill"))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "instances": len(kernel_instances()), "built": len(readings),
          "source_seconds": {name: round(r["seconds"], 2)
                             for name, r in readings.items()},
          "ptxas": ptxas})


def ptxas_lines(instance: str, kernel: str = "") -> list:
    """ptxas's register and spill lines for the kernels of the
    instantiations whose names start with ``instance``
    (``apgd_cone_solve_k4_f32``, ``warm_hybrid_solve_``), or for the entry
    functions of them whose (mangled) names contain ``kernel``
    (``model_loss_fwd_kernelIf``: K1's float32 instantiation)."""
    from dair_pll_tpu_torch.ops import soa_kernels
    section = "\n".join(reading["log"] for name, reading in
                        soa_kernels.build_readings().items()
                        if name.startswith(instance))
    return ptxas_of(section, kernel)


def ptxas_of(log: str, kernel: str = "") -> list:
    """ptxas's register and spill lines in one ``nvcc`` log, of every
    entry function or of those whose names contain ``kernel``."""
    lines, keep = [], not kernel
    for line in log.splitlines():
        if kernel and "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


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
            model, params, traj[:, 3],
            torch.zeros_like(traj[:, 0, :model.n_v]), DT,
            EPS, CONTACT_FILTER_EPS, *BUDGET)
        m, jc, qc, _, _ = soa_rollout_qp(model, params, traj[:, 4], DT)
    return m, jc, qc, w_carry.T.contiguous()


def float32_tails(k32, p32, p64):
    """The float32 rule: ``k32``, ``p32``, ``p64`` are the kernel's, the
    plain float32 and the plain float64 outputs, each a tuple of tensors
    whose last axis is the batch followed by the valid mask. A sample
    agrees when every output is within TOL32 (1 + |plain|) and the masks
    match; the others are tails, at most MAX_TAIL_SHARE of the batch, over
    which the kernel may be at most TAIL_FACTOR times further from float64
    than the plain float32 version, at the median and at the maximum.
    Returns ``(tail summary, tail mask)``."""
    import torch
    n = k32[-1].shape[0]

    def per_sample(a, b):
        out = torch.zeros(n, dtype=torch.float64, device=a[0].device)
        for x, y in zip(a[:-1], b[:-1]):
            d = (x.double() - y.double()).abs() / (1 + y.double().abs())
            out = torch.maximum(out, d.reshape(-1, n).amax(dim=0))
        return out

    tails = (per_sample(k32, p32) > TOL32) | (k32[-1] != p32[-1])
    n_tails = int(tails.sum().item())
    tail = {"samples": n_tails}
    if n_tails:
        err_k = per_sample(k32, p64)[tails]
        err_p = per_sample(p32, p64)[tails]
        tail.update(kernel_median=err_k.median().item(),
                    plain_median=err_p.median().item(),
                    kernel_max=err_k.max().item(),
                    plain_max=err_p.max().item())
    if n_tails > MAX_TAIL_SHARE * n:
        raise AssertionError(f"float32: {n_tails} of {n} samples differ "
                             f"beyond {TOL32}: {tail}")
    if n_tails and (
            tail["kernel_median"] > TAIL_FACTOR * tail["plain_median"] or
            tail["kernel_max"] > TAIL_FACTOR * tail["plain_max"]):
        raise AssertionError(f"float32 tails: the kernel is further from "
                             f"float64 than the plain version: {tail}")
    return tail, tails


def check_float64(name: str, got, ref) -> float:
    """Raises unless ``|got - ref| <= TOL64 (1 + |ref|)`` everywhere;
    returns the largest difference."""
    err = (got - ref).abs()
    if (err - TOL64 * (1 + ref.abs())).max().item() > 0:
        raise AssertionError(f"float64 {name} differs from the plain version "
                             f"by {err.max().item():.3e}")
    return err.max().item()


def compare_solve(kernel, plain, q64, args, n_out, name: str) -> dict:
    """A hybrid solve kernel against its plain version on float64 QPs and
    on the same cast to float32: float64 within TOL64 (1 + |plain|) with
    equal valid masks, float32 by the tail rule; the share of QPs with any
    impulse. Raises on a failure."""
    import torch
    q32 = tuple(t.float() for t in q64)
    with torch.no_grad():
        k64, p64 = kernel(*q64, *args), plain(*q64, *args)
        k32, p32 = kernel(*q32, *args), plain(*q32, *args)
    torch.cuda.synchronize()
    err64 = max(check_float64(f"{name} output {i}", k64[i], p64[i])
                for i in range(n_out))
    if not torch.equal(k64[-1], p64[-1]):
        raise AssertionError(f"float64 {name} valid masks differ")
    tail, _ = float32_tails(k32, p32, p64)
    return {"B": int(q64[0].shape[-1]), "max_abs_err_float64": err64,
            "max_abs_err": max((k32[i] - p32[i]).abs().max().item()
                               for i in range(n_out)),
            "float64_bit_identical": all(torch.equal(k64[i], p64[i])
                                         for i in range(n_out)),
            "float32_tails": tail,
            "valid_share": k32[-1].float().mean().item(),
            "max_abs_impulse": p64[0].abs().max().item(),
            "active_share": p64[0].abs().amax(dim=(0, 1)).gt(0).float()
            .mean().item()}


def phase_kernel(system, x0_64):
    """The cube's K5 (6, 4) against its plain version on the rollout's
    8,192 QPs (``rollout_qps``), on their first K5_RAGGED_B, whose last
    groups lie past the batch, and on K5_LARGE_B rollout QPs, where
    float32 runs one thread a QP (CUBE_K5_DESIGN); float64 bit for bit as
    well. Its times at 8,192 (and K5_LARGE_B) in both types and its bound
    in each from the operations its own body (``warm_solve_packed``) needs
    on these QPs, counted by the host build; ptxas's lines of its lanes
    in both types and of its one thread a QP in float32."""
    import numpy as np
    import torch
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.ops import soa_kernels
    kernel = soa_kernels.solve_warm_hybrid_soa_cuda_packed
    plain = soa_kernels.plain_packed
    args = (EPS, *BUDGET)

    params64 = system.initial_params(torch.float64)
    qps64 = rollout_qps(system, params64, x0_64)
    large64 = rollout_qps(system, params64, torch.tensor(
        assets.cube_states_near_ground(np.random.default_rng(0), K5_LARGE_B),
        dtype=torch.float64, device=x0_64.device))
    checks = [compare_solve(kernel, plain, qps64, args, 2, "K5 (6, 4)")]
    for n in K5_RAGGED_B:
        checks.append(compare_solve(
            kernel, plain, tuple(t[..., :n].contiguous() for t in qps64),
            args, 2, f"K5 (6, 4) at {n}"))
    checks.append(compare_solve(kernel, plain, large64, args, 2,
                                f"K5 (6, 4) at {K5_LARGE_B}"))
    if not all(c["float64_bit_identical"] for c in checks):
        raise AssertionError("float64 K5 (6, 4) on lanes is not the plain "
                             "version's bit for bit")
    emit({"phase": "kernel_vs_plain", "budget": list(BUDGET),
          "design": CUBE_K5_DESIGN, "checks": checks})

    qps32 = tuple(t.float() for t in qps64)
    timing = solve_timing(
        kernel, plain, qps32, args, 2,
        count=lambda q: host_model_terms().warm_solve_count(
            *q, *args, threads=os.cpu_count() or 1))
    large32 = tuple(t.float() for t in large64)
    with torch.no_grad():
        timing[f"ms_at_{K5_LARGE_B}"] = cuda_ms(
            lambda: kernel(*large32, *args), reps=20)
        timing[f"ms_float64_at_{K5_LARGE_B}"] = cuda_ms(
            lambda: kernel(*large64, *args), reps=10)
    for key, mangled in (("ptxas", "IfLi6ELi4ELi4E"),
                         ("ptxas_float64", "IdLi6ELi4ELi4E"),
                         ("ptxas_one_thread", "IfLi6ELi4ELi1E")):
        timing[key] = ptxas_lines("warm_hybrid_solve_nv6_k4_",
                                  "warm_hybrid_solve_kernel" + mangled)
    timing["active_share"] = checks[0]["active_share"]
    emit({"phase": "kernel_timing", "B": B, **timing})
    return {"max_abs_err": max(c["max_abs_err"] for c in checks),
            "max_abs_err_float64": max(c["max_abs_err_float64"]
                                       for c in checks),
            "design": CUBE_K5_DESIGN, **timing}


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
    time per step in the unprofiled rollout. Then 16 rollout steps timed
    after the trace, beside the rate of the rollout phase before any
    trace."""
    import torch
    params = system.initial_params(torch.float32)
    x0 = x0_64.float()
    system.simulate_batch(params, x0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    profiled = profile_step(lambda: system.simulate_batch(params, x0, 1),
                            step_seconds)
    seconds = time.perf_counter() - t0
    after = 16
    a0 = time.perf_counter()
    system.simulate_batch(params, x0, after)
    torch.cuda.synchronize()
    emit({"phase": "profile", "B": B, "steps": 1, "seconds": seconds,
          "steps_per_s_before_trace": 1 / step_seconds,
          "steps_per_s_after_trace": after / (time.perf_counter() - a0),
          "device_kernels_per_step": profiled["device_kernels"],
          "device_ms_per_step": profiled["device_ms"],
          "host_ms_per_step": step_seconds * 1e3,
          "device_busy_share": profiled["device_busy_share"],
          "top_kernels_ms_per_step": profiled["top_kernels_ms"]})


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


def derived_vector(system, params):
    """The packed derived scalars the loss kernels take, detached."""
    from dair_pll_tpu_torch.multibody.soa_terms import derive_scalar_params
    from dair_pll_tpu_torch.ops.soa_loss_kernels import pack_derived
    return pack_derived(system.model,
                        derive_scalar_params(system.model, params)).detach()


def adam_step(system, params, x, x_plus) -> float:
    """One training step through the entry point: mean cold loss,
    backward, Adam; returns the loss."""
    import torch
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=LR)
    u = x.new_zeros((x.shape[0], 0))
    loss = torch.mean(system.contactnets_loss_batch(params, x, u, x_plus,
                                                    use_fused=True))
    loss.backward()
    optimizer.step()
    return loss.item()


def phase_loss_kernels(system, x0_64):
    """K1, K3 and K2 against their plain versions on 8,192 transitions of
    the port's float64 rollout from states near the ground."""
    x64, xp64 = model_transitions(system, x0_64)
    result, pvec = compare_loss_kernels(system, x64, xp64)
    emit({"phase": "loss_kernels_vs_plain", "B": B, **result})
    return result, (x64, xp64, pvec)


def compare_loss_kernels(system, x64, xp64):
    """K1, K3 and K2 of a model against their plain versions on float64
    transitions ``(x64, xp64)``: K1 (cold) and K3 (warm, from K1's
    impulses at parameters one Adam step on) in float64 within TOL64 with
    equal valid masks, K2 within the gradient bar and bit for bit from run
    to run; in float32 the K5 rule and DP_FACTOR. Returns the readings and
    the float32 derived vector one step on."""
    import torch
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    model = system.model
    n = x64.shape[0]
    # Parameters one Adam step from the initial ones (K1 and K2 on the
    # entry point), where K3 warm-starts from K1's impulses.
    params1 = system.initial_params(torch.float64)
    adam_step(system, params1, x64, xp64)
    pvecs = {torch.float64: (derived_vector(
        system, system.initial_params(torch.float64)),
        derived_vector(system, params1))}
    pvecs[torch.float32] = tuple(p.float() for p in pvecs[torch.float64])

    def sync(out):
        torch.cuda.synchronize()
        return out

    runs = {}
    for dtype in (torch.float64, torch.float32):
        p0, p1 = pvecs[dtype]
        xin, xp = (x64.T.to(dtype).contiguous(), xp64.T.to(dtype).contiguous())
        ct = torch.ones(n, dtype=dtype, device=xin.device)
        k1 = sync(lk.fused_loss_fwd(model, p0, xin, xp, DT, LOSS_EPS,
                                    *COLD_BUDGET))
        q1 = lk.plain_loss_fwd(model, p0, xin, xp, DT, LOSS_EPS, *COLD_BUDGET)
        k3 = sync(lk.fused_loss_fwd_warm(model, p1, xin, xp, k1[1], DT,
                                         LOSS_EPS, *WARM_BUDGET))
        q3 = lk.plain_loss_fwd_warm(model, p1, xin, xp, k1[1], DT, LOSS_EPS,
                                    *WARM_BUDGET)
        k2 = sync(lk.fused_loss_bwd(model, p1, xin, xp, k3[1], k3[2], ct, DT,
                                    LOSS_EPS))
        k2_again = sync(lk.fused_loss_bwd(model, p1, xin, xp, k3[1], k3[2],
                                          ct, DT, LOSS_EPS))
        q2 = lk.plain_loss_bwd(model, p1, xin, xp, k3[1], k3[2], ct, DT,
                               LOSS_EPS)
        if not all(torch.equal(a, b) for a, b in zip(k2, k2_again)):
            raise AssertionError(f"{dtype}: two K2 runs differ")
        runs[dtype] = {"K1": (k1, q1), "K3": (k3, q3), "K2": (k2, q2)}

    result = {}
    for name in ("K1", "K3"):
        (k64, q64), (k32, q32) = (runs[torch.float64][name],
                                  runs[torch.float32][name])
        err64 = max(check_float64(f"{name} {what}", k64[i], q64[i])
                    for i, what in ((0, "loss"), (1, "impulse")))
        if not torch.equal(k64[2], q64[2]):
            raise AssertionError(f"float64 {name} valid masks differ")
        tail, _ = float32_tails(k32, q32, q64)
        err32 = max((g - r).abs().max().item()
                    for g, r in zip(k32[:2], q32[:2]))
        result[name] = {"max_abs_err_float64": err64, "max_abs_err": err32,
                        "float32_tails": tail,
                        "valid_share": k32[2].float().mean().item()}
    (k64, q64), (k32, q32) = (runs[torch.float64]["K2"],
                              runs[torch.float32]["K2"])
    for what, got, ref in zip(("dp", "dxin", "dxp"), k64, q64):
        excess = (got - ref).abs() - (GRAD_ATOL + GRAD_RTOL * ref.abs())
        if excess.max().item() > 0:
            raise AssertionError(f"float64 K2 {what} differs from the plain "
                                 f"backward by {(got - ref).abs().max():.3e}")

    def rel_l2(a, b):
        return ((a.double() - b).norm() / b.norm()).item()

    dp_kernel, dp_plain = rel_l2(k32[0], q64[0]), rel_l2(q32[0], q64[0])
    if dp_kernel > DP_FACTOR * dp_plain:
        raise AssertionError(f"float32 K2 batch gradient: rel-l2 "
                             f"{dp_kernel:.3e} from float64, plain float32 "
                             f"{dp_plain:.3e}")
    result["K2"] = {
        "max_abs_err_float64": max((g - r).abs().max().item()
                                   for g, r in zip(k64, q64)),
        "max_abs_err": max((g - r).abs().max().item()
                           for g, r in zip(k32, q32)),
        "dp_rel_l2_float32_kernel": dp_kernel,
        "dp_rel_l2_float32_plain": dp_plain,
        "float64_bit_identical": {
            name: torch.equal(runs[torch.float64][name][0][0],
                              runs[torch.float64][name][1][0])
            for name in ("K1", "K3")}}
    return result, pvecs[torch.float32][1]


def phase_loss_timing(system, transitions, x_train, xp_train):
    """K1, K3 and K2 at the training shape (float32), the plain versions
    at 8,192, and each kernel's bound from the operations its own code
    needs: K1's and K3's (``cube_terms.cuh`` with ``hybrid_solve.cuh``)
    counted on the first COUNT_B samples of this batch and scaled, K2's
    (its sweep, ``cube_adjoint.cuh``) over the whole batch, both by the
    host builds of ``ops/host_adjoint.py``, beside the plain versions'
    counts. K1, K3 and K2 also in float64, with their bounds at the
    float64 peak; K1's and K3's times at each (ipm, newton) budget of
    SOLVE_BUDGETS with the split into the terms, an IPM and a Newton
    iteration (``budget_timing``); ptxas's lines for the three kernels in
    both types."""
    import torch
    from dair_pll_tpu_torch.ops import host_adjoint
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    model = system.model
    x64, xp64, pvec = transitions
    xin, xp = x64.T.float().contiguous(), xp64.T.float().contiguous()
    xin_t, xp_t = x_train.T.contiguous(), xp_train.T.contiguous()
    n_train = xin_t.shape[1]
    ct, ct_t = torch.ones_like(xin[0]), torch.ones_like(xin_t[0])

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    cold = lk.fused_loss_fwd(model, pvec, xin_t, xp_t, DT, LOSS_EPS,
                             *COLD_BUDGET)
    small = lk.fused_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                              *COLD_BUDGET)
    calls = {
        "K1": (lambda: lk.fused_loss_fwd(model, pvec, xin_t, xp_t, DT,
                                         LOSS_EPS, *COLD_BUDGET),
               lambda: lk.plain_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                                         *COLD_BUDGET),
               nbytes(pvec, xin_t, xp_t, *cold)),
        "K3": (lambda: lk.fused_loss_fwd_warm(model, pvec, xin_t, xp_t,
                                              cold[1], DT, LOSS_EPS,
                                              *WARM_BUDGET),
               lambda: lk.plain_loss_fwd_warm(model, pvec, xin, xp, small[1],
                                              DT, LOSS_EPS, *WARM_BUDGET),
               nbytes(pvec, xin_t, xp_t, cold[1], *cold)),
        "K2": (lambda: lk.fused_loss_bwd(model, pvec, xin_t, xp_t, cold[1],
                                         cold[2], ct_t, DT, LOSS_EPS),
               lambda: lk.plain_loss_bwd(model, pvec, xin, xp, small[1],
                                         small[2], ct, DT, LOSS_EPS),
               nbytes(pvec, xin_t, xp_t, cold[1], cold[2], ct_t, pvec, xin_t,
                      xp_t)),
    }
    result = {}
    for name, (kernel, plain, n_bytes) in calls.items():
        ms = cuda_ms(kernel, reps=10)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        ops = host_adjoint.count_torch_operations(plain) * (n_train / B)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS_PER_S["float32"] * 1e3
        result[name] = {
            "ms": ms, "plain_ms": plain_ms, "plain_B": B, "bytes": n_bytes,
            "operations": ops, "operations_per_sample": ops / n_train,
            "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    # K1's and K3's operations: what their own bodies need on this batch's
    # first COUNT_B samples (K3 warm-started from K1's impulses, as timed),
    # counted by the same code on the host and scaled; the plain versions'
    # counts stay beside them.
    host_terms = host_model_terms()
    cols = slice(0, min(COUNT_B, n_train))
    scale = n_train / (cols.stop - cols.start)
    t0 = time.perf_counter()
    for name, kind, budget in (("K1", "cold", COLD_BUDGET),
                               ("K3", "warm", WARM_BUDGET)):
        entry = result[name]
        for dtype in ("float32", "float64"):
            args = [t.to(getattr(torch, dtype)) for t in (
                pvec, xin_t[:, cols], xp_t[:, cols], cold[1][..., cols])]
            c = host_terms.cube_count(kind, *args[:3],
                                      args[3] if kind == "warm" else None,
                                      DT, LOSS_EPS, *budget,
                                      threads=os.cpu_count() or 1)
            ops = c["needed"] * scale
            ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
            if dtype == "float32":
                entry.update({
                    "operations_plain": entry["operations"],
                    "operations_plain_per_sample":
                        entry["operations_per_sample"],
                    "operations": ops, "operations_per_sample": ops / n_train,
                    "operations_executed": c["executed"] * scale,
                    "count_B": cols.stop, "operations_ms": ops_ms,
                    "bound_ms": max(entry["bytes_ms"], ops_ms),
                    "bound_by": ("bytes" if entry["bytes_ms"] >= ops_ms
                                 else "operations")})
            else:
                # Every value in 8 bytes but the valid mask's byte a sample.
                bytes_ms = (2 * entry["bytes"] - n_train) / \
                    HBM_BYTES_PER_S * 1e3
                entry.update({
                    "operations_float64": ops,
                    "bound_ms_float64": max(bytes_ms, ops_ms),
                    "bound_by_float64": ("bytes" if bytes_ms >= ops_ms
                                         else "operations")})
    # K1's cold solve leaves its loops at their exact fixed points: the
    # shares of its iterations that were, and its operations without the
    # exits, on the same samples.
    result["K1"]["exits"] = exit_readings(
        lambda dtype, exits: host_terms.cube_count(
            "cold", *(t.to(dtype) for t in (pvec, xin_t[:, cols],
                                            xp_t[:, cols])), None, DT,
            LOSS_EPS, *COLD_BUDGET, threads=os.cpu_count() or 1,
            exits=bool(exits)), cols.stop, COLD_BUDGET)
    result["K3"]["count_seconds"] = time.perf_counter() - t0
    # K2's operations are not its plain version's (torch autograd's dense
    # algebra over the structural zeros and ones of Jw = [R | 0] and Jv =
    # [0 | I]): they are what its sweep needs on this run's data, counted by
    # the same code on the host (host_adjoint), an invalid sample none,
    # plus the batch sum of dp. Float64 counts the float64 sweep.
    # Counted on the first COUNT_B samples and scaled, as K1's and K3's.
    k2 = result["K2"]
    p_d, xin_d, xp_d, force_d, ct_d = (
        t.double() for t in (pvec, xin_t, xp_t, cold[1], ct_t))
    host = host_build("adjoint")
    t0 = time.perf_counter()
    scale = n_train / cols.stop
    counts = {dtype: {key: value * scale for key, value in host.count(
        p, *(t[..., cols].contiguous() for t in (xin, xp, force)),
        cold[2][cols].contiguous(), ct[cols].contiguous(), DT,
        threads=os.cpu_count() or 1).items()}
              for dtype, (p, xin, xp, force, ct) in (
                  ("float32", (pvec, xin_t, xp_t, cold[1], ct_t)),
                  ("float64", (p_d, xin_d, xp_d, force_d, ct_d)))}
    batch_sum = pvec.numel() * (n_train - 1)
    ops = {dtype: c["needed"] + batch_sum for dtype, c in counts.items()}
    n_valid = counts["float32"]["valid"]
    ops_ms = ops["float32"] / PEAK_OPS_PER_S["float32"] * 1e3
    k2.update({
        "operations": ops["float32"],
        "operations_per_sample": ops["float32"] / n_train,
        "operations_per_valid_sample":
            counts["float32"]["needed"] / max(n_valid, 1),
        "operations_executed": counts["float32"]["executed"] + batch_sum,
        "operations_plain": k2["operations"],
        "operations_plain_per_sample": k2["operations_per_sample"],
        "valid_share": n_valid / n_train, "count_seconds":
            time.perf_counter() - t0,
        "operations_ms": ops_ms, "bound_ms": max(k2["bytes_ms"], ops_ms),
        "bound_by": "bytes" if k2["bytes_ms"] >= ops_ms else "operations",
        "executed_per_s": (counts["float32"]["executed"] + batch_sum) /
                          (k2["ms"] * 1e-3)})
    k2["ms_float64"] = cuda_ms(
        lambda: lk.fused_loss_bwd(model, p_d, xin_d, xp_d, force_d, cold[2],
                                  ct_d, DT, LOSS_EPS), reps=10)
    bytes64_ms = nbytes(p_d, xin_d, xp_d, force_d, cold[2], ct_d, p_d, xin_d,
                        xp_d) / HBM_BYTES_PER_S * 1e3
    ops64_ms = ops["float64"] / PEAK_OPS_PER_S["float64"] * 1e3
    k2["operations_float64"] = ops["float64"]
    k2["bound_ms_float64"] = max(bytes64_ms, ops64_ms)
    k2["bound_by_float64"] = ("bytes" if bytes64_ms >= ops64_ms
                              else "operations")
    for name, fn in (("K1", lambda: lk.fused_loss_fwd(
            model, p_d, xin_d, xp_d, DT, LOSS_EPS, *COLD_BUDGET)),
                     ("K3", lambda: lk.fused_loss_fwd_warm(
                         model, p_d, xin_d, xp_d, force_d, DT, LOSS_EPS,
                         *WARM_BUDGET))):
        result[name]["ms_float64"] = cuda_ms(fn, reps=5)
    del p_d, xin_d, xp_d, force_d, ct_d
    result["budgets"] = budget_timing(model, pvec, xin_t, xp_t, cold[1],
                                      reps=3)
    for name, kernel in (("K1", "contactnets_loss_fwd_kernel"),
                         ("K3", "contactnets_loss_fwd_warm_kernel"),
                         ("K2", "contactnets_loss_bwd_kernel")):
        for key, mangled in (("ptxas", "If"), ("ptxas_float64", "Id")):
            result[name][key] = ptxas_lines("contactnets_loss_cube",
                                            kernel + mangled)
    emit({"phase": "loss_kernel_timing", "B": n_train, "dtype": "float32",
          **result})
    return result


def plain_over_chunks(fn, chunk: int, *cols):
    """``fn`` over blocks of ``chunk`` samples of the batch-minor ``cols``,
    its outputs joined along the batch axis."""
    import torch
    n = cols[0].shape[-1]
    outs = [fn(*(c[..., s:s + chunk].contiguous() for c in cols))
            for s in range(0, n, chunk)]
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*outs))


def phase_loss_full_batch(system, pvec, x_train, xp_train,
                          chunks=(PLAIN_FWD_CHUNK, PLAIN_BWD_CHUNK),
                          phase="loss_kernels_vs_plain_full"):
    """K1, K3 and K2 at the training shape (2,097,152 samples) against
    their plain versions, which run over chunks of the batch. Float32
    inputs as the training step gives them, each also cast to float64:
    K1 and K3 (warm-started from K1's float32 impulses) by the float32
    rule (tails decided against the plain float64 result) and in float64
    within TOL64; K2 at the impulses of the float32 K3 with ``ct = 1/B``
    (the mean's cotangent), in float64 within the gradient bar and bit for
    bit from run to run (its second pass then sums 16,384 block partials),
    and in float32 with ``dp``, ``dxin`` and ``dxp`` each no further from
    the float64 plain result, in rel-l2, than DP_FACTOR times the plain
    float32 version's (or F32_GRAD_FLOOR). Reports every reading before it
    raises."""
    import torch
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    model = system.model
    n = x_train.shape[0]
    inputs = {torch.float32: (pvec, x_train.T.contiguous(),
                              xp_train.T.contiguous())}
    inputs[torch.float64] = tuple(t.double() for t in inputs[torch.float32])
    failures, result = [], {}

    def check(ok, message):
        if not ok:
            failures.append(message)

    def forward(name, kernel, plain, *extra):
        out = {}
        for dtype, (p, xin, xp) in inputs.items():
            ext = tuple(t.to(dtype) for t in extra)
            out[dtype] = (
                kernel(model, p, xin, xp, *ext),
                plain_over_chunks(lambda a, b, *c: plain(model, p, a, b, *c),
                                  chunks[0], xin, xp, *ext))
        torch.cuda.synchronize()
        (k64, q64), (k32, q32) = out[torch.float64], out[torch.float32]
        err64 = max((k64[i] - q64[i]).abs().max().item() for i in (0, 1))
        check(all(((k64[i] - q64[i]).abs() <=
                   TOL64 * (1 + q64[i].abs())).all().item() for i in (0, 1)),
              f"float64 {name} differs from the plain version by {err64:.3e}")
        check(torch.equal(k64[2], q64[2]), f"float64 {name} valid masks differ")
        try:
            tail, _ = float32_tails(k32, q32, q64)
        except AssertionError as exc:
            tail = str(exc)
            failures.append(f"{name}: {exc}")
        result[name] = {
            "max_abs_err_float64": err64,
            "max_abs_err": max((k32[i] - q32[i]).abs().max().item()
                               for i in (0, 1)),
            "float32_tails": tail,
            "valid_share": k32[2].float().mean().item()}
        return k32

    def fwd_cold(m, p, xin, xp):
        return lk.fused_loss_fwd(m, p, xin, xp, DT, LOSS_EPS, *COLD_BUDGET)

    def plain_cold(m, p, xin, xp):
        return lk.plain_loss_fwd(m, p, xin, xp, DT, LOSS_EPS, *COLD_BUDGET)

    def fwd_warm(m, p, xin, xp, fprev):
        return lk.fused_loss_fwd_warm(m, p, xin, xp, fprev, DT, LOSS_EPS,
                                      *WARM_BUDGET)

    def plain_warm(m, p, xin, xp, fprev):
        return lk.plain_loss_fwd_warm(m, p, xin, xp, fprev, DT, LOSS_EPS,
                                      *WARM_BUDGET)

    k1 = forward("K1", fwd_cold, plain_cold)
    k3 = forward("K3", fwd_warm, plain_warm, k1[1])
    del k1

    # K2 at K3's float32 impulses, ct = 1/B.
    grads = {}
    for dtype, (p, xin, xp) in inputs.items():
        force, valid = k3[1].to(dtype), k3[2]
        ct = torch.full((n,), 1.0 / n, dtype=dtype, device=xin.device)
        kernel = lk.fused_loss_bwd(model, p, xin, xp, force, valid, ct, DT,
                                   LOSS_EPS)
        if dtype == torch.float64:
            again = lk.fused_loss_bwd(model, p, xin, xp, force, valid, ct,
                                      DT, LOSS_EPS)
            check(all(torch.equal(a, b) for a, b in zip(kernel, again)),
                  "two float64 K2 runs at the training shape differ")
            del again
        dps, dxins, dxps = [], [], []
        for s in range(0, n, chunks[1]):
            cols = slice(s, s + chunks[1])
            dp, dxin, dxp = lk.plain_loss_bwd(
                model, p, xin[:, cols].contiguous(),
                xp[:, cols].contiguous(), force[..., cols].contiguous(),
                valid[cols].contiguous(), ct[cols].contiguous(), DT, LOSS_EPS)
            dps.append(dp)
            dxins.append(dxin)
            dxps.append(dxp)
        plain = (torch.stack(dps).sum(dim=0), torch.cat(dxins, dim=-1),
                 torch.cat(dxps, dim=-1))
        grads[dtype] = (kernel, plain)
    torch.cuda.synchronize()
    del k3
    (k64, q64), (k32, q32) = grads[torch.float64], grads[torch.float32]
    entry = {"max_abs_err_float64": max((g - r).abs().max().item()
                                        for g, r in zip(k64, q64)),
             "max_abs_err": max((g - r).abs().max().item()
                                for g, r in zip(k32, q32))}
    for what, g64, r64, g32, r32 in zip(("dp", "dxin", "dxp"), k64, q64,
                                        k32, q32):
        excess = (g64 - r64).abs() - (GRAD_ATOL + GRAD_RTOL * r64.abs())
        check(excess.max().item() <= 0,
              f"float64 K2 {what} at the training shape differs from the "
              f"plain backward by {(g64 - r64).abs().max().item():.3e}")
        ref_norm = r64.norm()
        kernel_l2 = ((g32.double() - r64).norm() / ref_norm).item()
        plain_l2 = ((r32.double() - r64).norm() / ref_norm).item()
        entry[f"{what}_rel_l2_float32_kernel"] = kernel_l2
        entry[f"{what}_rel_l2_float32_plain"] = plain_l2
        check(kernel_l2 <= DP_FACTOR * max(plain_l2, F32_GRAD_FLOOR),
              f"float32 K2 {what} at the training shape: rel-l2 "
              f"{kernel_l2:.3e} from float64, plain float32 {plain_l2:.3e}")
    result["K2"] = entry
    emit({"phase": phase, "B": n, "ct": "1/B", "failures": failures,
          **result})
    del grads, inputs
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return result


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel."""
    from dair_pll_tpu_torch.ops import soa_kernels
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    from dair_pll_tpu_torch.ops import cone_kernels
    return {"K1": lk.fused_loss_fwd, "K3": lk.fused_loss_fwd_warm,
            "K2": lk.fused_loss_bwd,
            "K4": soa_kernels.solve_contact_impulse_soa_cuda,
            "K5": soa_kernels.solve_warm_hybrid_soa_cuda,
            "K6": cone_kernels.solve_cone_qp_cuda}


def reset_launches() -> None:
    from dair_pll_tpu_torch.ops import soa_kernels
    for counter in launch_counters().values():
        soa_kernels.reset_launches(counter)


def read_launches() -> dict:
    return {name: counter.launches
            for name, counter in launch_counters().items()}


def read_launches_by() -> dict:
    """Each kernel's launches by instantiation (``"cube"``, a generic
    loss size, ``"nv7_k8"``...), where it counts them."""
    return {name: dict(getattr(counter, "launches_by", {}))
            for name, counter in launch_counters().items()}


def train_transitions(n: int, device):
    """``bench.py``'s cube transitions in seeded numpy: random unit
    quaternions, heights 0.06-0.11 m, ``x_plus`` a 0.005 perturbation."""
    import numpy as np
    import torch
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, 13)).astype(np.float32)
    quat = x[:, :4] / np.linalg.norm(x[:, :4], axis=-1, keepdims=True)
    height = 0.06 + 0.05 * rng.random((n, 1), dtype=np.float32)
    x = np.concatenate((quat, x[:, 4:6] * 0.1, height, x[:, 7:] * 0.5),
                       axis=-1)
    x_plus = x + 0.005 * rng.standard_normal((n, 13), dtype=np.float32)
    x_plus[:, :4] /= np.linalg.norm(x_plus[:, :4], axis=-1, keepdims=True)
    return (torch.tensor(x, device=device),
            torch.tensor(x_plus, device=device))


class TrainingRun:
    """Adam at lr LR on a system's float32 initial parameters over the
    transitions ``(x, x_plus)``, through the training entry points: a cold
    step, the impulse cache's seed (``bench.py``'s: the warm call from
    zeros at the cold budget) and WARM_STEPS epoch-warm steps."""

    def __init__(self, system, x, x_plus):
        import torch
        self.system, self.x, self.x_plus = system, x, x_plus
        self.u = x.new_zeros((x.shape[0], 0))
        self.params = system.initial_params(torch.float32)
        self.leaves = self.params.parameters()
        for leaf in self.leaves:
            leaf.requires_grad_(True)
        self.start = [leaf.detach().clone() for leaf in self.leaves]
        self.optimizer = torch.optim.Adam(self.leaves, lr=LR)

    def cold_step(self, n=None, use_fused=None):
        """A cold step on the first ``n`` transitions (all by default)."""
        import torch
        self.optimizer.zero_grad()
        loss = torch.mean(self.system.contactnets_loss_batch(
            self.params, self.x[:n], self.u[:n], self.x_plus[:n], use_fused))
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def seed(self):
        import torch
        with torch.no_grad():
            return self.system.contactnets_loss_batch_warm(
                self.params, self.x, self.u, self.x_plus,
                self.x.new_zeros((3, self.system.model.n_contacts,
                                  self.x.shape[0])),
                budget=COLD_BUDGET)[1]

    def warm_step(self, cache):
        import torch
        self.optimizer.zero_grad()
        loss, cache = self.system.contactnets_loss_batch_warm(
            self.params, self.x, self.u, self.x_plus, cache)
        loss = torch.mean(loss)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), cache

    def round(self):
        """A cold step, the seed and the warm steps, each timed."""
        import torch
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        loss = self.cold_step()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - c0
        cache = self.seed()
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - c0 - cold_s
        losses, warm_s = [loss], []
        for _ in range(WARM_STEPS):
            w0 = time.perf_counter()
            loss, cache = self.warm_step(cache)
            torch.cuda.synchronize()
            warm_s.append(time.perf_counter() - w0)
            losses.append(loss)
        return cold_s, seed_s, warm_s, torch.stack(losses), cache

    def timed(self):
        """A warm-up round, then a timed round with the launch counts and
        the peak memory read around it. Returns ``(report, cache)``."""
        import torch
        self.round()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        cold_s, seed_s, warm_s, losses, cache = self.round()
        launches = read_launches()
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"non-finite losses {losses.tolist()}")
        n = self.x.shape[0]
        return {"B": n, "dtype": "float32",
                "warm_budget": list(WARM_BUDGET), "warm_steps": WARM_STEPS,
                "cold_step_ms": cold_s * 1e3, "seed_ms": seed_s * 1e3,
                "warm_step_median_ms": statistics.median(warm_s) * 1e3,
                "warm_step_ms": [w * 1e3 for w in warm_s],
                "cold_transitions_per_s": n / cold_s,
                "warm_transitions_per_s": n * WARM_STEPS / sum(warm_s),
                "losses": losses.tolist(), "launches": launches,
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated()}, cache

    def moved(self):
        """Per leaf, whether training moved it."""
        import torch
        return [not torch.equal(a, b.detach())
                for a, b in zip(self.start, self.leaves)]


def phase_train(system, x, x_plus):
    """``bench.py``'s training workload (:class:`TrainingRun`), with a
    trace of one warm step; returns the launch counts of the timed
    round."""
    run = TrainingRun(system, x, x_plus)
    report, cache = run.timed()
    if not all(run.moved()):
        raise AssertionError("a parameter tensor did not move in training")
    # K3 runs once for the seed and once per warm step.
    expected = {"K1": 1, "K3": 1 + WARM_STEPS, "K2": 1 + WARM_STEPS,
                "K4": 0, "K5": 0, "K6": 0}
    if report["launches"] != expected:
        raise AssertionError(f"launches {report['launches']}, expected "
                             f"{expected}")
    emit({"phase": "train", **report,
          "profiled_warm_step": profile_step(
              lambda: run.warm_step(cache),
              report["warm_step_median_ms"] / 1e3)})
    return report["launches"]


def kernel_kind(name: str) -> str:
    """A kernel's kind by its name: the port's own kernels, matrix
    products (cuBLAS and CUTLASS), or PyTorch's other kernels
    (elementwise, reductions, copies)."""
    if any(key in name for key in ("hybrid_solve", "contactnets_loss",
                                   "apgd_cone_solve", "model_loss",
                                   "model_reduce_partials")):
        return "port_kernels"
    if "gemm" in name:
        return "matmul"
    return "other"


def profile_step(step, step_seconds: float) -> dict:
    """Kernels on the card in one ``step()``, from a ``torch.profiler``
    trace, and their share of the unprofiled step's ``step_seconds``."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - h0) * 1e3
    per_name = collections.Counter()
    kernels = 0
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            per_name[event.name] += event.time_range.elapsed_us()
            kernels += 1
    device_ms = sum(per_name.values()) / 1e3
    by_kind = collections.Counter()
    for name, us in per_name.items():
        by_kind[kernel_kind(name)] += us / 1e3
    return {"host_ms_profiled": profiled_ms, "device_ms": device_ms,
            "device_kernels": kernels, "device_ms_by_kind": by_kind,
            "device_busy_share": (device_ms / (step_seconds * 1e3)
                                  if kernels else None),
            "top_kernels_ms": [[name[:80], us / 1e3]
                               for name, us in per_name.most_common(6)]}


def icnn_states(system, params, n: int):
    """``(n, 13)`` float64 states of the ICNN cube near the ground at
    ``params``."""
    import numpy as np
    import torch
    from dair_pll_tpu_torch import assets
    return torch.tensor(assets.icnn_states_near_ground(
        np.random.default_rng(2), n, params.geometry[1]["icnn"],
        system.model.geometries[1].icnn_negative_slope),
        dtype=torch.float64, device=system.device)


def cold_loss_qps(system, params, x, x_plus):
    """The packed QPs ``(m, jc, qc)`` that the cold ContactNets loss of
    transitions ``(x, x_plus)`` hands its solve: captured at
    ``solve_contact_impulse_soa_cuda_packed`` in one call of
    ``contactnets_loss_batch``, which launches K4 once."""
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    solve = soa_kernels.solve_contact_impulse_soa_cuda_packed
    captured = []

    def capture(m, jc, qc, *args):
        captured.append((m, jc, qc))
        return solve(m, jc, qc, *args)

    soa_kernels.solve_contact_impulse_soa_cuda_packed = capture
    try:
        with torch.no_grad():
            system.contactnets_loss_batch(
                params, x, x.new_zeros((x.shape[0], 0)), x_plus,
                use_fused=True)
    finally:
        soa_kernels.solve_contact_impulse_soa_cuda_packed = solve
    if len(captured) != 1:
        raise AssertionError(f"the cold loss solved {len(captured)} times")
    return captured[0]


def cold_solve_vs_plain_full(qps32, phase: str):
    """K4 against its plain version run over chunks of ICNN_PLAIN_CHUNK on
    the float32 QPs a main path hands it, and on the same cast to float64:
    float64 within TOL64 (1 + |plain|) with equal valid masks, float32 by
    the K5 rule. Reports every reading as ``phase`` before it raises;
    returns the float32 and the float64 largest errors."""
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    kernel = soa_kernels.solve_contact_impulse_soa_cuda_packed
    plain = soa_kernels.plain_packed_cold
    qps64 = tuple(t.double() for t in qps32)
    shape = tuple(qps32[1].shape[1:3])
    failures, out = [], {}
    for dtype, qps in ((torch.float64, qps64), (torch.float32, qps32)):
        with torch.no_grad():
            out[dtype] = (kernel(*qps, LOSS_EPS, *COLD_BUDGET),
                          plain_over_chunks(
                              lambda *c: plain(*c, LOSS_EPS, *COLD_BUDGET),
                              ICNN_PLAIN_CHUNK, *qps))
    torch.cuda.synchronize()
    (f64, q64), (f32, q32) = out[torch.float64], out[torch.float32]
    err64 = (f64[0] - q64[0]).abs().max().item()
    if ((f64[0] - q64[0]).abs() - TOL64 * (1 + q64[0].abs())).max() > 0:
        failures.append(f"float64 K4 at {shape} differs from the plain "
                        f"version by {err64:.3e}")
    if not torch.equal(f64[0], q64[0]):
        failures.append(f"float64 K4 at {shape} is not the plain version's "
                        f"bit for bit")
    if not torch.equal(f64[1], q64[1]):
        failures.append(f"float64 K4 valid masks differ at {shape}")
    try:
        tail, _ = float32_tails(f32, q32, q64)
    except AssertionError as exc:
        tail = str(exc)
        failures.append(f"K4 at {shape}: {exc}")
    err32 = (f32[0] - q32[0]).abs().max().item()
    emit({"phase": phase, "B": qps32[0].shape[-1], "shape": list(shape),
          "plain_chunk": ICNN_PLAIN_CHUNK, "failures": failures,
          "float64_max_abs_err": err64,
          "float64_bit_identical": torch.equal(f64[0], q64[0]),
          "float32_max_abs_err": err32, "float32_tails": tail,
          "valid_share": f32[1].float().mean().item(),
          "max_abs_impulse": q64[0].abs().max().item()})
    if failures:
        raise AssertionError("; ".join(failures))
    return err32, err64


def phase_icnn_kernel(system, x0_64, x_train, xp_train):
    """K4 against its plain version on the ICNN cube's cold loss QPs: at
    8,192 samples of its float64 rollout, and at the training batch, whose
    float32 QPs (and the same cast to float64) are the main path's cold
    step's, against the plain version run over chunks. Its times at the
    training batch and the plain version's at 8,192; its bound. Reports
    every reading before it raises."""
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    from dair_pll_tpu_torch.ops.host_adjoint import count_torch_operations
    kernel = soa_kernels.solve_contact_impulse_soa_cuda_packed
    plain = soa_kernels.plain_packed_cold
    params64 = system.initial_params(torch.float64)
    traj = system.simulate_batch(params64, x0_64, 4, use_fused=True)
    qps64 = cold_loss_qps(system, params64, traj[:, 3], traj[:, 4])
    qps32 = tuple(t.float() for t in qps64)

    def run(fn, qps):
        with torch.no_grad():
            out = fn(*qps, LOSS_EPS, *COLD_BUDGET)
        torch.cuda.synchronize()
        return out

    k64, p64 = run(kernel, qps64), run(plain, qps64)
    k32, p32 = run(kernel, qps32), run(plain, qps32)
    err64 = check_float64("K4 impulse", k64[0], p64[0])
    if not torch.equal(k64[1], p64[1]):
        raise AssertionError("float64 K4 valid masks differ")
    if not torch.equal(k64[0], p64[0]):
        raise AssertionError("float64 K4 is not the plain version's bit for "
                             "bit")
    tail, _ = float32_tails(k32, p32, p64)
    err32 = (k32[0] - p32[0]).abs().max().item()
    emit({"phase": "icnn_kernel_vs_plain", "B": B,
          "budget": list(COLD_BUDGET), "float64_max_abs_err": err64,
          "float64_bit_identical": torch.equal(k64[0], p64[0]),
          "float32_max_abs_err": err32, "float32_tails": tail,
          "valid_share": k32[1].float().mean().item(),
          "max_abs_impulse": p64[0].abs().max().item()})
    del qps64, k64, p64, k32, p32

    # The training batch, against the plain version over chunks.
    train32 = cold_loss_qps(system, system.initial_params(torch.float32),
                            x_train, xp_train)
    train64 = tuple(t.double() for t in train32)
    n_train = x_train.shape[0]
    full_err32, full_err64 = cold_solve_vs_plain_full(
        train32, "icnn_kernel_vs_plain_full")

    # Times at the training batch (float32, as the training step runs
    # it, and float64), the plain version's at 8,192, and the bound from
    # the operations K4's own body needs on these QPs in each type (its
    # count on the first COUNT_B, scaled; the plain version's count
    # beside it), with the shares of its loops' iterations that were
    # fixed points.
    with torch.no_grad():
        ms = cuda_ms(lambda: kernel(*train32, LOSS_EPS, *COLD_BUDGET),
                     reps=10)
        ms64 = cuda_ms(lambda: kernel(*train64, LOSS_EPS, *COLD_BUDGET),
                       reps=5)
        result = kernel(*train32, LOSS_EPS, *COLD_BUDGET)
        plain_ms = cuda_ms(lambda: plain(*qps32, LOSS_EPS, *COLD_BUDGET),
                           reps=3, warmup=1)
        plain_ops = count_torch_operations(
            lambda: plain(*qps32, LOSS_EPS, *COLD_BUDGET)) * (n_train / B)
    t0 = time.perf_counter()
    ops, ops64 = (k4_count(qps)["needed"] for qps in (train32, train64))
    exits = k4_exit_readings(train32)
    count_seconds = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in train32 + result)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S["float32"] * 1e3
    ops64_ms = ops64 / PEAK_OPS_PER_S["float64"] * 1e3
    bytes64_ms = (2 * n_bytes - n_train) / HBM_BYTES_PER_S * 1e3
    timing = {"ms": ms, "ms_float64": ms64, "plain_ms": plain_ms,
              "plain_B": B, "bytes": n_bytes, "operations": ops,
              "operations_per_sample": ops / n_train,
              "operations_float64": ops64,
              "operations_plain": plain_ops,
              "operations_plain_per_sample": plain_ops / n_train,
              "count_B": min(COUNT_B, n_train),
              "count_seconds": count_seconds, "exits": exits,
              "bytes_ms": bytes_ms, "operations_ms": ops_ms,
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "bound_ms_float64": max(bytes64_ms, ops64_ms),
              "bound_by_float64": ("bytes" if bytes64_ms >= ops64_ms
                                   else "operations"),
              "design": K4_DESIGN["nv6_k4"], **k4_ptxas("nv6_k4")}
    emit({"phase": "icnn_kernel_timing", "B": n_train, "dtype": "float32",
          **timing})
    return {"max_abs_err": max(err32, full_err32),
            "max_abs_err_float64": max(err64, full_err64), **timing}


def params_to(params, device):
    """A detached copy of ``params`` on ``device``."""
    import dataclasses

    def move(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {key: move(value) for key, value in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(move(value) for value in tree)
        return tree.detach().to(device)

    return dataclasses.replace(params, theta=move(params.theta),
                               friction=move(params.friction),
                               geometry=move(params.geometry))


def icnn_loss_readings(system, params, x, x_plus) -> dict:
    """The cold loss, the cache's seed and one warm loss of transitions
    ``(x, x_plus)`` through the training entry points: per-sample losses,
    impulses and the gradient of each mean loss for every leaf (``None``
    where a leaf gets none), on the CPU."""
    import torch
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    u = x.new_zeros((x.shape[0], 0))

    def grads(loss):
        for leaf in leaves:
            leaf.grad = None
        torch.mean(loss).backward()
        return [None if leaf.grad is None else leaf.grad.cpu()
                for leaf in leaves]

    cold = system.contactnets_loss_batch(params, x, u, x_plus,
                                         use_fused=True)
    readings = {"cold_grad": grads(cold), "cold_loss": cold.detach().cpu()}
    with torch.no_grad():
        _, seed = system.contactnets_loss_batch_warm(
            params, x, u, x_plus,
            x.new_zeros((3, system.model.n_contacts, x.shape[0])),
            budget=COLD_BUDGET)
    warm, force = system.contactnets_loss_batch_warm(params, x, u, x_plus,
                                                     seed)
    readings.update(warm_grad=grads(warm), warm_loss=warm.detach().cpu(),
                    seed_force=seed.cpu(), warm_force=force.cpu())
    return readings


def phase_icnn_loss_vs_cpu(system, x0_64, x_train, xp_train):
    """The ICNN cube's cold and warm float64 loss and every leaf's gradient
    on ICNN_CHECK_B transitions, on the card (plain terms, K4 and K5)
    against the CPU (plain terms and solves), at the same parameters
    (``loss_card_vs_cpu``). Half the transitions are the training
    batch's, which start deep in the initial shape and solve to zero
    impulses; half are steps 3 to 4 of the ICNN cube's rollout from
    states near the ground, which carry contact impulses."""
    import torch
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    cpu_system = MultibodyLearnableSystem(system.model, DT, device="cpu")
    half = ICNN_CHECK_B // 2
    traj = cpu_system.simulate_batch(cpu_system.initial_params(torch.float64),
                                     x0_64[:half].cpu(), 4,
                                     use_fused=True).to(system.device)
    x = torch.cat((x_train[:half].double(), traj[:, 3]))
    x_plus = torch.cat((xp_train[:half].double(), traj[:, 4]))
    loss_card_vs_cpu(system, x, x_plus, "icnn_loss_card_vs_cpu", {},
                     {"K4": {"nv6_k4": 1}, "K5": {"nv6_k4": 2}})


def phase_icnn_train(system, x, x_plus):
    """The ICNN cube's training (:class:`TrainingRun`); one step at the
    reference recipe's batch; a URDF export of the trained shape; last, a
    trace of one warm step. Returns the launch counts of the timed
    round."""
    import tempfile
    import torch
    from dair_pll_tpu_torch.urdf_export import (
        represent_multibody_terms_as_urdfs)
    run = TrainingRun(system, x, x_plus)
    report, cache = run.timed()
    # The perturbations' gradient is zero: a support point of the
    # piecewise-linear ICNN is piecewise constant in its direction.
    moved = run.moved()
    if run.leaves[-1].grad is not None or moved[-1]:
        raise AssertionError("the ICNN perturbations got a gradient")
    if not all(moved[:-1]):
        raise AssertionError("an ICNN weight did not move in training")
    # K4 runs once for the cold step; K5 for the seed and each warm step.
    expected = {"K1": 0, "K3": 0, "K2": 0, "K4": 1, "K5": 1 + WARM_STEPS,
                "K6": 0}
    if report["launches"] != expected:
        raise AssertionError(f"ICNN launches {report['launches']}, "
                             f"expected {expected}")

    # The reference recipe's batch, below FUSED_LOSS_MIN_BATCH.
    reset_launches()
    r0 = time.perf_counter()
    ref_loss = run.cold_step(ICNN_REF_B, use_fused=True)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - r0) * 1e3
    ref_launches = read_launches()
    if ref_launches["K4"] != 1 or not bool(torch.isfinite(ref_loss)):
        raise AssertionError(f"batch {ICNN_REF_B}: launches {ref_launches},"
                             f" loss {ref_loss.item()}")

    with tempfile.TemporaryDirectory() as out_dir:
        e0 = time.perf_counter()
        urdfs = represent_multibody_terms_as_urdfs(system.model, run.params,
                                                   out_dir)
        export_s = time.perf_counter() - e0
        obj = [name for name in os.listdir(out_dir) if name.endswith(".obj")]
        with open(os.path.join(out_dir, obj[0]), encoding="utf-8") as handle:
            lines = handle.read().splitlines()
    mesh = {"vertices": sum(line.startswith("v ") for line in lines),
            "faces": sum(line.startswith("f ") for line in lines),
            "seconds": export_s}
    if mesh["faces"] < 4 or obj[0] not in urdfs["cube"]:
        raise AssertionError(f"URDF export of the trained ICNN: {mesh}")
    emit({"phase": "icnn_train", **report,
          "reference_batch": {"B": ICNN_REF_B, "step_ms": ref_ms,
                              "loss": ref_loss.item(),
                              "launches": ref_launches},
          "urdf_export_mesh": mesh,
          "profiled_warm_step": profile_step(
              lambda: run.warm_step(cache),
              report["warm_step_median_ms"] / 1e3)})
    return report["launches"]


def phase_icnn_rollout(system, x0_64):
    """ICNN cube rollouts: 8,192 x ICNN_STEPS in float32 with K5's
    launches; 8 x 10 steps in float64 on the card against the CPU."""
    import torch
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    params = system.initial_params(torch.float32)
    x0 = x0_64.float()
    system.simulate_batch(params, x0[:1024], 2)          # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    traj = system.simulate_batch(params, x0, ICNN_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if tuple(traj.shape) != (B, ICNN_STEPS + 1, 13):
        raise AssertionError(f"ICNN trajectory shape {tuple(traj.shape)}")
    if not bool(torch.isfinite(traj).all()):
        raise AssertionError("non-finite states in the ICNN rollout")
    if launches["K5"] != ICNN_STEPS or launches["K4"] != 0:
        raise AssertionError(f"launches {launches} in a {ICNN_STEPS}-step "
                             "ICNN rollout")

    x_check = x0_64[:CHECK_TRAJ]
    gpu = system.simulate_batch(system.initial_params(torch.float64),
                                x_check, CHECK_STEPS, use_fused=True)
    cpu_system = MultibodyLearnableSystem(system.model, DT, device="cpu")
    cpu = cpu_system.simulate_batch(cpu_system.initial_params(torch.float64),
                                    x_check.cpu(), CHECK_STEPS,
                                    use_fused=True)
    check_err = (gpu.cpu() - cpu).abs().max().item()
    if not check_err <= ROLLOUT_ATOL:
        raise AssertionError(f"float64 ICNN rollout on the card differs from "
                             f"the CPU by {check_err:.3e}")
    emit({"phase": "icnn_rollout", "B": B, "steps": ICNN_STEPS,
          "dtype": "float32", "seconds": seconds,
          "steps_per_s": ICNN_STEPS / seconds,
          "transitions_per_s": B * ICNN_STEPS / seconds,
          "launches": launches,
          "float64_card_vs_cpu_max_abs_err": check_err})
    return launches


def apgd_loss_qps(system, params, x, x_plus):
    """``(Q, q)`` of the vmapped ContactNets loss of transitions ``(x,
    x_plus)``: ``Q = D + LOSS_EPS I`` and ``q_vec``, detached, as the
    APGD kernel route hands them to K6."""
    import torch
    with torch.no_grad():
        delassus, q_vec, _, _, _, _ = system._contactnets_qp(
            params, x, x.new_zeros((x.shape[0], 0)), x_plus)
    eye = torch.eye(delassus.shape[-1], dtype=x.dtype, device=x.device)
    return (delassus + LOSS_EPS * eye).contiguous(), q_vec.contiguous()


def random_psd_qps(n_problems: int, k: int, device, ridge: float = 0.1):
    """Random PSD problems of the JAX package's
    ``tests/test_pallas_cone_solver.py`` recipe, float64: ``Q = A A' +
    ridge I`` (the recipe's ridge is 0.1), ``q = 2 N(0, 1)``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(40 + k)
    n = 3 * k
    A = rng.standard_normal((n_problems, n, n))
    Q = A @ np.swapaxes(A, -1, -2) + ridge * np.eye(n)
    q = 2.0 * rng.standard_normal((n_problems, n))
    return (torch.tensor(Q, device=device), torch.tensor(q, device=device))


def k6_outputs(fn, Q, q):
    """``fn(Q, q, APGD_ITERATIONS)`` as the float32 rule takes outputs:
    ``(x (n, B), valid (B,))`` with the contact solve's failure mask."""
    import torch
    from dair_pll_tpu_torch.ops.socp_solver import mask_failures
    with torch.no_grad():
        x = fn(Q, q, APGD_ITERATIONS)
    torch.cuda.synchronize()
    _, valid = mask_failures(x)
    return x.T.contiguous(), valid


def compare_k6(Q64, q64, chunk=None):
    """K6 against its plain version on float64 problems and on the same
    cast to float32: float64 within TOL64 (1 + |plain|) with equal masks,
    float32 by the tail rule against the plain float64 result. The plain
    version runs over blocks of ``chunk`` problems when given. Returns
    ``(readings, failures)``."""
    import torch
    from dair_pll_tpu_torch.ops import cone_kernels
    kernel = cone_kernels.solve_cone_qp_cuda
    n = q64.shape[0]
    chunk = chunk or n

    def plain(Q, q, iterations):
        return torch.cat([cone_kernels.plain_apgd(
            Q[s:s + chunk], q[s:s + chunk], iterations)
            for s in range(0, n, chunk)])

    Q32, q32 = Q64.float(), q64.float()
    k64, p64 = k6_outputs(kernel, Q64, q64), k6_outputs(plain, Q64, q64)
    k32, p32 = k6_outputs(kernel, Q32, q32), k6_outputs(plain, Q32, q32)
    failures = []
    err64 = (k64[0] - p64[0]).abs().max().item()
    if ((k64[0] - p64[0]).abs() - TOL64 * (1 + p64[0].abs())).max() > 0:
        failures.append(f"float64 K6 differs from the plain version by "
                        f"{err64:.3e}")
    if not torch.equal(k64[1], p64[1]):
        failures.append("float64 K6 valid masks differ")
    try:
        tail, _ = float32_tails(k32, p32, p64)
    except AssertionError as exc:
        tail = str(exc)
        failures.append(f"float32 K6: {exc}")
    readings = {"B": n, "k": q64.shape[-1] // 3, "float64_max_abs_err": err64,
                "float64_bit_identical": torch.equal(k64[0], p64[0]),
                "float32_max_abs_err": (k32[0] - p32[0]).abs().max().item(),
                "float32_bit_identical": torch.equal(k32[0], p32[0]),
                "float32_tails": tail,
                "valid_share": k32[1].float().mean().item(),
                "valid_share_float64": k64[1].float().mean().item(),
                "max_abs_impulse": p64[0].abs().max().item()}
    return readings, failures


def phase_apgd_kernel(system, x0_64):
    """K6 against its plain version on 8,192 problems of each of four
    kinds: the cube's vmapped loss QPs (steps 3 to 4 of its float64
    rollout from states near the ground, k = 4) and random PSD problems at
    k = 1, 4 and 9; then the random problems at the ragged batches of
    K6_RAGGED_B (the plain version over chunks), whose last groups and
    warps lie past the batch. Reports every reading before it raises."""
    import torch
    params64 = system.initial_params(torch.float64)
    traj = system.simulate_batch(params64, x0_64, 4, use_fused=True)
    kinds = {"cube_loss": apgd_loss_qps(system, params64, traj[:, 3],
                                        traj[:, 4])}
    for k in (1, 4, 9):
        Q, q = random_psd_qps(max(K6_RAGGED_B), k, x0_64.device)
        for n in (B, *K6_RAGGED_B):
            kinds[f"random_k{k}" + ("" if n == B else f"_{n}")] = (
                Q[:n].contiguous(), q[:n].contiguous())
    failures, result = [], {}
    for name, (Q, q) in kinds.items():
        result[name], fails = compare_k6(Q, q, APGD_PLAIN_CHUNK)
        failures += [f"{name}: {f}" for f in fails]
    emit({"phase": "apgd_kernel_vs_plain", "iterations": APGD_ITERATIONS,
          "failures": failures, **result})
    if failures:
        raise AssertionError("; ".join(failures))
    return {"max_abs_err": max(r["float32_max_abs_err"]
                               for r in result.values()),
            "max_abs_err_float64": max(r["float64_max_abs_err"]
                                       for r in result.values())}


def apgd_operations(Q, q) -> int:
    """Operations of the APGD solve of ``(Q, q)``: the plain version's,
    counted with each reduction as the plain sum of its ``n`` terms (the
    plain version pads them to the kernel's 32 lanes, which is no work of
    the solve)."""
    from dair_pll_tpu_torch.ops import cone_kernels
    from dair_pll_tpu_torch.ops.host_adjoint import count_torch_operations
    warp_sum = cone_kernels._warp_sum
    cone_kernels._warp_sum = lambda v: v.sum(-1)
    try:
        return count_torch_operations(
            lambda: cone_kernels.plain_apgd(Q, q, APGD_ITERATIONS))
    finally:
        cone_kernels._warp_sum = warp_sum


def apgd_timing(Q32, q32, ops_per_problem: float) -> dict:
    """K6's times on ``(Q32, q32)`` and on the same in float64 (median of
    10), and its bound: the bytes of Q, q and x, and the operations."""
    import torch
    from dair_pll_tpu_torch.ops import cone_kernels
    kernel = cone_kernels.solve_cone_qp_cuda
    Q64, q64 = Q32.double(), q32.double()
    with torch.no_grad():
        ms = cuda_ms(lambda: kernel(Q32, q32, APGD_ITERATIONS), reps=10)
        ms64 = cuda_ms(lambda: kernel(Q64, q64, APGD_ITERATIONS), reps=10)
    n_problems = q32.shape[0]
    ops = ops_per_problem * n_problems
    n_bytes = (Q32.numel() + 2 * q32.numel()) * Q32.element_size()
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S["float32"] * 1e3
    return {"B": n_problems, "ms": ms, "ms_float64": ms64, "bytes": n_bytes,
            "operations": ops, "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_apgd_timing(system):
    """K6 on cube loss QPs of the training recipe's transitions, float32
    and float64: at VMAPPED_BIG_B, the batch the main path (the K6
    route's training step) hands it, which the kernel table reports, and
    at APGD_TIMING_B. Also the plain version at 8,192, the operations per
    problem (the same for every problem: the solve runs a fixed number of
    iterations) and ptxas's lines for the kernel."""
    import torch
    from dair_pll_tpu_torch.ops import cone_kernels
    x, x_plus = train_transitions(APGD_TIMING_B, system.device)
    Q32, q32 = apgd_loss_qps(system, system.initial_params(torch.float32), x,
                             x_plus)
    small = (Q32[:B].contiguous(), q32[:B].contiguous())
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: cone_kernels.plain_apgd(
            *small, APGD_ITERATIONS), reps=3, warmup=1)
        ops_per_problem = apgd_operations(*small) / B
    main = apgd_timing(Q32[:VMAPPED_BIG_B].contiguous(),
                       q32[:VMAPPED_BIG_B].contiguous(), ops_per_problem)
    large = apgd_timing(Q32, q32, ops_per_problem)
    ptxas = ptxas_lines("apgd_cone_solve_k4_f32")
    timing = {**main, "plain_ms": plain_ms, "plain_B": B,
              "operations_per_problem": ops_per_problem,
              "at_timing_b": large}
    emit({"phase": "apgd_kernel_timing", "dtype": "float32",
          "iterations": APGD_ITERATIONS, "design": K6_DESIGN,
          "ptxas": ptxas, **timing})
    del Q32, q32, small
    torch.cuda.empty_cache()
    return timing


def phase_apgd_divergence(system):
    """Float32 APGD divergence: the share of problems whose solution is
    not finite or exceeds 1e3, from K6 and from its plain version (over
    chunks), in float32 and float64, on DIVERGENCE_B random k = 4 problems
    at each ridge of DIVERGENCE_RIDGES; the first diverged problems'
    indices in float32 (``scripts/probe_apgd_divergence.py`` replays such
    problems in the JAX package on the CPU)."""
    import torch
    from dair_pll_tpu_torch.ops import cone_kernels
    from dair_pll_tpu_torch.ops.socp_solver import mask_failures
    result = {}
    for ridge in DIVERGENCE_RIDGES:
        Q64, q64 = random_psd_qps(DIVERGENCE_B, 4, system.device, ridge)
        entry = {}
        for dtype in (torch.float32, torch.float64):
            key = str(dtype).split(".")[1]
            Q, q = Q64.to(dtype), q64.to(dtype)
            with torch.no_grad():
                kernel = cone_kernels.solve_cone_qp_cuda(Q, q,
                                                         APGD_ITERATIONS)
                plain = torch.cat([cone_kernels.plain_apgd(
                    Q[s:s + APGD_PLAIN_CHUNK], q[s:s + APGD_PLAIN_CHUNK],
                    APGD_ITERATIONS) for s in range(0, q.shape[0],
                                                    APGD_PLAIN_CHUNK)])
            for name, x in (("kernel", kernel), ("plain", plain)):
                _, valid = mask_failures(x)
                entry[f"{name}_{key}_diverged_share"] = (
                    1.0 - valid.float().mean().item())
            entry[f"kernel_{key}_diverged_first"] = torch.nonzero(
                ~mask_failures(kernel)[1]).flatten()[:64].tolist()
            entry[f"{key}_kernel_equals_plain"] = torch.equal(kernel, plain)
            del Q, q, kernel, plain
        result[f"ridge_{ridge:g}"] = entry
        del Q64, q64
        torch.cuda.empty_cache()
    emit({"phase": "apgd_divergence", "B": DIVERGENCE_B, "k": 4,
          "iterations": APGD_ITERATIONS, **result})


def vmapped_trainer(system, x, x_plus, **route):
    """A training step on the vmapped loss (mean, backward, Adam at LR)
    from float32 initial parameters; returns the step, which returns the
    detached loss."""
    import torch
    params = system.initial_params(torch.float32)
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=LR)
    u = x.new_zeros((x.shape[0], 0))

    def step():
        optimizer.zero_grad()
        loss = torch.mean(system.contactnets_loss_batch(params, x, u, x_plus,
                                                        **route))
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def vmapped_steps(system, x, x_plus, steps: int, **route):
    """``steps`` vmapped training steps, each timed to the card's end,
    after one step of warm-up; the launch counts around the timed steps.
    Returns ``(step seconds, losses, launches)``."""
    import torch
    step = vmapped_trainer(system, x, x_plus, **route)
    step()
    torch.cuda.synchronize()
    reset_launches()
    seconds, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = read_launches()
    losses = torch.stack(losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite vmapped losses {losses.tolist()}")
    return seconds, losses.tolist(), launches


def phase_vmapped_profile(system):
    """Where a vmapped training step's time goes: a ``torch.profiler``
    trace of one step on the default route at VMAPPED_B and one on the K6
    route at VMAPPED_BIG_B, each beside the same step timed untraced just
    before. Runs last: a trace slows later launches in the process."""
    import torch
    x, x_plus = train_transitions(VMAPPED_BIG_B, system.device)
    result = {}
    for name, n, route in (("default", VMAPPED_B, {}),
                           ("apgd_kernel_big", VMAPPED_BIG_B,
                            {"use_apgd_kernel": True})):
        step = vmapped_trainer(system, x[:n], x_plus[:n], **route)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        result[name] = {"B": n, "step_ms": seconds * 1e3,
                        **profile_step(step, seconds)}
    emit({"phase": "vmapped_profile", "dtype": "float32", **result})


def phase_vmapped_train(system):
    """The box cube's vmapped training step: the default route (the hybrid
    solve in plain PyTorch) at the reference recipe's batch of 256
    transitions, which launches no kernel, then the APGD kernel route at
    256 and at 65,536, which launches K6 once a step. Returns the K6
    route's launches at 65,536."""
    x, x_plus = train_transitions(VMAPPED_BIG_B, system.device)
    runs = {}
    for name, n, route in (("default", VMAPPED_B, {}),
                           ("apgd_kernel", VMAPPED_B,
                            {"use_apgd_kernel": True}),
                           ("apgd_kernel_big", VMAPPED_BIG_B,
                            {"use_apgd_kernel": True})):
        seconds, losses, launches = vmapped_steps(
            system, x[:n], x_plus[:n], VMAPPED_STEPS, **route)
        expected = dict.fromkeys(launches, 0)
        if route:
            expected["K6"] = VMAPPED_STEPS
        if launches != expected:
            raise AssertionError(f"vmapped {name}: launches {launches}, "
                                 f"expected {expected}")
        median = statistics.median(seconds)
        runs[name] = {"B": n, "step_ms_median": median * 1e3,
                      "step_ms": [t * 1e3 for t in seconds],
                      "transitions_per_s": n / median, "losses": losses,
                      "launches": launches}
    emit({"phase": "vmapped_train", "dtype": "float32",
          "steps": VMAPPED_STEPS, **runs})
    return runs["apgd_kernel_big"]["launches"]


def phase_apgd_full(system):
    """K6 on the 65,536 problems the APGD kernel route's training step
    hands it, captured at its wrapper, against the plain version over
    chunks: in float32 by the tail rule and on the same cast to
    float64."""
    import torch
    from dair_pll_tpu_torch.ops import cone_kernels
    solve = cone_kernels.solve_cone_qp_cuda
    captured = []

    def capture(Q, q, iterations):
        captured.append((Q, q))
        return solve(Q, q, iterations)

    # While it stands in, the wrapper counts its launch here.
    from dair_pll_tpu_torch.ops.soa_kernels import reset_launches as reset
    reset(capture)

    x, x_plus = train_transitions(VMAPPED_BIG_B, system.device)
    cone_kernels.solve_cone_qp_cuda = capture
    try:
        with torch.no_grad():
            system.contactnets_loss_batch(
                system.initial_params(torch.float32), x,
                x.new_zeros((x.shape[0], 0)), x_plus, use_apgd_kernel=True)
    finally:
        cone_kernels.solve_cone_qp_cuda = solve
    if len(captured) != 1:
        raise AssertionError(f"the K6 route solved {len(captured)} times")
    Q, q = captured[0]
    readings, failures = compare_k6(Q.double(), q.double(), APGD_PLAIN_CHUNK)
    emit({"phase": "apgd_kernel_vs_plain_full", "plain_chunk":
          APGD_PLAIN_CHUNK, "failures": failures, **readings})
    if failures:
        raise AssertionError("; ".join(failures))
    return readings


def vmapped_readings(system, params, x, x_plus, x0) -> dict:
    """On one device, float64: the vmapped loss on the hybrid and the K6
    routes with every leaf's gradient of its mean, the vmapped rollout of
    ``x0`` over CHECK_STEPS steps, and every leaf's gradient of the mean
    squared velocity over its first VMAPPED_STEPS steps (the IFT backward
    of each step's hybrid solve), all on the CPU."""
    import torch
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    u = x.new_zeros((x.shape[0], 0))

    def grads(loss):
        for leaf in leaves:
            leaf.grad = None
        loss.backward()
        return [None if leaf.grad is None else leaf.grad.cpu()
                for leaf in leaves]

    out = {}
    for route, kwargs in (("hybrid", {}), ("apgd_kernel",
                                           {"use_apgd_kernel": True})):
        loss = system.contactnets_loss_batch(params, x, u, x_plus, **kwargs)
        out[f"{route}_loss"] = loss.detach().cpu()
        out[f"{route}_grad"] = grads(torch.mean(loss))
    traj = system.simulate_batch(params, x0, CHECK_STEPS, use_fused=False)
    out["rollout"] = traj.detach().cpu()
    out["rollout_grad"] = grads(torch.mean(
        traj[:, 1:VMAPPED_STEPS + 1, system.space.n_q:] ** 2))
    return out


def phase_vmapped_vs_cpu(systems, x0s, x_train, xp_train):
    """The vmapped stack in float64 on the card against the CPU at the same
    parameters, for the box cube and the ICNN cube: the loss on 16
    transitions (8 of the training recipe, 8 rollout steps in contact) on
    the hybrid and K6 routes with every leaf's gradient (loss rtol
    LOSS_RTOL, gradients rtol GRAD_RTOL), the vmapped rollout of 8
    trajectories x CHECK_STEPS steps (atol ROLLOUT_ATOL) and the IFT
    gradient of a rollout loss (rtol GRAD_RTOL). Reports every reading
    before it raises."""
    import torch
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    failures, result = [], {}
    half = VMAPPED_CHECK_B // 2
    for name, system in systems.items():
        cpu_system = MultibodyLearnableSystem(system.model, DT, device="cpu")
        params_cpu = cpu_system.initial_params(torch.float64)
        x0 = x0s[name][:CHECK_TRAJ].cpu()
        traj = cpu_system.simulate_batch(params_cpu, x0, 4, use_fused=True)
        x = torch.cat((x_train[:half].double().cpu(), traj[:, 3]))
        x_plus = torch.cat((xp_train[:half].double().cpu(), traj[:, 4]))
        reset_launches()
        card = vmapped_readings(
            system, params_to(params_cpu, system.device),
            x.to(system.device), x_plus.to(system.device),
            x0.to(system.device))
        launches = read_launches()
        cpu = vmapped_readings(cpu_system, params_cpu, x, x_plus, x0)
        entry = {"launches": launches}
        expected = dict.fromkeys(launches, 0)
        expected["K6"] = 1
        if launches != expected:
            failures.append(f"{name}: launches {launches}, expected "
                            f"{expected}")
        for route in ("hybrid", "apgd_kernel"):
            got, ref = card[f"{route}_loss"], cpu[f"{route}_loss"]
            entry[f"{route}_loss_max_abs_err"] = (got - ref).abs().max().item()
            if not torch.allclose(got, ref, rtol=LOSS_RTOL, atol=LOSS_ATOL):
                failures.append(f"{name} {route} loss differs by "
                                f"{entry[f'{route}_loss_max_abs_err']:.3e}")
        for what in ("hybrid_grad", "apgd_kernel_grad", "rollout_grad"):
            errs = []
            for i, (g, r) in enumerate(zip(card[what], cpu[what])):
                if (g is None) != (r is None):
                    failures.append(f"{name} {what} of leaf {i}: card "
                                    f"{g is not None}, CPU {r is not None}")
                    continue
                if g is None:
                    errs.append(None)
                    continue
                errs.append((g - r).abs().max().item())
                if not torch.allclose(g, r, rtol=GRAD_RTOL,
                                      atol=CPU_GRAD_ATOL):
                    failures.append(f"{name} {what} of leaf {i} differs by "
                                    f"{errs[-1]:.3e}")
            entry[f"{what}_max_abs_err_per_leaf"] = errs
        rollout_err = (card["rollout"] - cpu["rollout"]).abs().max().item()
        entry["rollout_max_abs_err"] = rollout_err
        if not rollout_err <= ROLLOUT_ATOL:
            failures.append(f"{name} vmapped rollout differs by "
                            f"{rollout_err:.3e}")
        entry["max_abs_loss"] = cpu["hybrid_loss"].abs().max().item()
        entry["min_center_height_m"] = cpu["rollout"][..., 6].min().item()
        result[name] = entry
    emit({"phase": "vmapped_card_vs_cpu", "B": VMAPPED_CHECK_B,
          "dtype": "float64", "failures": failures, **result})
    if failures:
        raise AssertionError("; ".join(failures))


def phase_vmapped_rollout(system, x0_64):
    """``simulate_batch`` of the box cube at VMAPPED_B trajectories x
    VMAPPED_ROLLOUT_STEPS steps on its default (vmapped) route, float32:
    steps per second, and the time of one gradient (the mean squared
    velocity's, through every step's IFT backward); no kernel runs."""
    import torch
    params = system.initial_params(torch.float32)
    leaves = params.parameters()
    x0 = x0_64[:VMAPPED_B].float()
    system.simulate_batch(params, x0, 1)                  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        traj = system.simulate_batch(params, x0, VMAPPED_ROLLOUT_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for leaf in leaves:
        leaf.requires_grad_(True)
    g0 = time.perf_counter()
    traj_g = system.simulate_batch(params, x0, VMAPPED_ROLLOUT_STEPS)
    torch.mean(traj_g[:, 1:, system.space.n_q:] ** 2).backward()
    torch.cuda.synchronize()
    grad_seconds = time.perf_counter() - g0
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the vmapped rollout launched {launches}")
    if tuple(traj.shape) != (VMAPPED_B, VMAPPED_ROLLOUT_STEPS + 1, 13) or \
            not bool(torch.isfinite(traj).all()):
        raise AssertionError("vmapped rollout: bad shape or non-finite")
    if not all(bool(torch.isfinite(leaf.grad).all()) for leaf in leaves):
        raise AssertionError("vmapped rollout gradient is not finite")
    emit({"phase": "vmapped_rollout", "B": VMAPPED_B,
          "steps": VMAPPED_ROLLOUT_STEPS, "dtype": "float32",
          "seconds": seconds, "steps_per_s": VMAPPED_ROLLOUT_STEPS / seconds,
          "transitions_per_s": VMAPPED_B * VMAPPED_ROLLOUT_STEPS / seconds,
          "forward_and_gradient_seconds": grad_seconds,
          "launches": launches,
          "min_center_height_m": traj[..., 6].min().item()})


# -- the elbow and the generic loss kernels ---------------------------------------
def elbow_system(asset: str = "elbow", **kwargs):
    """The elbow's ``MultibodyLearnableSystem`` on the card, from an asset
    (``elbow`` in boxes, ``elbow_mesh`` as an ICNN or, with
    ``mesh_representation="polygon"``, in polygons)."""
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    return MultibodyLearnableSystem.from_urdfs(
        {"elbow": assets.get_asset(asset)}, DT, **kwargs)


def states_near_ground(system, n: int, seed: int):
    """``(n, n_x)`` float64 states of a free-base model on the card near
    the ground at the initial parameters
    (``assets.tree_states_near_ground``)."""
    import numpy as np
    import torch
    from dair_pll_tpu_torch import assets
    return torch.tensor(assets.tree_states_near_ground(
        np.random.default_rng(seed), n, system.model), device=system.device)


def elbow_train_transitions(n: int, device):
    """The training recipe (``train_transitions``, ``bench.py``'s for the
    cube) carried to the elbow's 15 states: a unit quaternion, xy times
    0.1, height 0.06-0.11 m, the hinge angle uniform in (-pi, pi],
    velocities 0.5 N(0, 1); ``x_plus`` a 0.005 N(0, 1) perturbation with
    the quaternion renormalised; seeded numpy, float32."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, 15)).astype(np.float32)
    quat = x[:, :4] / np.linalg.norm(x[:, :4], axis=-1, keepdims=True)
    height = 0.06 + 0.05 * rng.random((n, 1), dtype=np.float32)
    angle = rng.uniform(-np.pi, np.pi, (n, 1)).astype(np.float32)
    x = np.concatenate((quat, x[:, 4:6] * 0.1, height, angle,
                        x[:, 8:] * 0.5), axis=-1)
    x_plus = x + 0.005 * rng.standard_normal((n, 15), dtype=np.float32)
    x_plus[:, :4] /= np.linalg.norm(x_plus[:, :4], axis=-1, keepdims=True)
    return (torch.tensor(x, device=device),
            torch.tensor(x_plus, device=device))


def solve_timing(kernel, plain, qps32, args, n_result, count=None,
                 plain_b=None) -> dict:
    """A solve kernel's times on float32 QPs (and the same cast to
    float64), its plain version's (on the first ``plain_b`` QPs, if
    given, its count scaled to the batch), and its bound: the bytes it
    moves and the operations its plain version counts, or, with ``count``
    (QPs -> ``{"needed": ...}``, the kernel's own body counted on the
    host), the operations its own code needs on these QPs in each type
    (the plain version's count then beside them as ``operations_plain``),
    with a float64 bound of its own."""
    import torch
    from dair_pll_tpu_torch.ops.host_adjoint import count_torch_operations
    qps64 = tuple(t.double() for t in qps32)
    n = qps32[0].shape[-1]
    part = tuple(t[..., :plain_b].contiguous() for t in qps32) \
        if plain_b is not None else qps32
    with torch.no_grad():
        ms = cuda_ms(lambda: kernel(*qps32, *args), reps=20)
        ms64 = cuda_ms(lambda: kernel(*qps64, *args), reps=10)
        result = kernel(*qps32, *args)
        plain_ms = cuda_ms(lambda: plain(*part, *args), reps=3, warmup=1)
        ops = count_torch_operations(lambda: plain(*part, *args)) * (
            n / part[0].shape[-1])
    n_bytes = sum(t.numel() * t.element_size()
                  for t in qps32 + tuple(result[:n_result]))
    out = {"ms": ms, "ms_float64": ms64, "plain_ms": plain_ms,
           "plain_B": part[0].shape[-1], "bytes": n_bytes}
    if count is not None:
        t0 = time.perf_counter()
        own = {dtype: count(tuple(t.cpu() for t in qps))["needed"]
               for dtype, qps in (("float32", qps32), ("float64", qps64))}
        out.update({"operations_plain": ops,
                     "operations_plain_per_sample": ops / n,
                     "operations_float64": own["float64"],
                     "count_seconds": time.perf_counter() - t0})
        ops = own["float32"]
        bytes64_ms = 2 * n_bytes / HBM_BYTES_PER_S * 1e3
        ops64_ms = own["float64"] / PEAK_OPS_PER_S["float64"] * 1e3
        out.update({"bound_ms_float64": max(bytes64_ms, ops64_ms),
                    "bound_by_float64": ("bytes" if bytes64_ms >= ops64_ms
                                         else "operations")})
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S["float32"] * 1e3
    out.update({"operations": ops, "operations_per_sample": ops / n,
                "bytes_ms": bytes_ms, "operations_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    return out


def phase_elbow_kernel(system, icnn_system, x0_64, x0_icnn):
    """K5 and K4 at the elbow's (n_v, k) = (7, 8) against their plain
    versions: K5 on 8,192 QPs of the elbow's float64 fused rollout step
    near the ground at the rollout budget (14, 6), eps 1e-4; K4 on the
    ICNN elbow's cold loss QPs of its own rollout, (10, 10), eps 1e-3.
    Float64 within TOL64 (1 + |plain|) with equal valid masks, float32 by
    the K5 rule; K5 (on lanes, K5_DESIGN) float64 also bit for bit. The
    share of QPs with any impulse. K5's times at 8,192 in both types and
    its bound in each type from the operations its own body
    (``warm_solve_packed``) needs on these QPs, counted by the host build
    (K4's are taken at its main path's shape, ``phase_elbow_icnn_loss``);
    ptxas's lines of both in float32 and float64."""
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    warm = soa_kernels.solve_warm_hybrid_soa_cuda_packed
    cold = soa_kernels.solve_contact_impulse_soa_cuda_packed
    out = {}
    qps = {"K5": rollout_qps(system, system.initial_params(torch.float64),
                             x0_64)}
    p_icnn = icnn_system.initial_params(torch.float64)
    traj = icnn_system.simulate_batch(p_icnn, x0_icnn, 4, use_fused=True)
    qps["K4"] = cold_loss_qps(icnn_system, p_icnn, traj[:, 3], traj[:, 4])
    for name, kernel, plain, args, n_out in (
            ("K5", warm, soa_kernels.plain_packed, (EPS, *BUDGET), 2),
            ("K4", cold, soa_kernels.plain_packed_cold,
             (LOSS_EPS, *COLD_BUDGET), 1)):
        q64 = qps[name]
        if tuple(q64[1].shape[1:3]) != (7, 8):
            raise AssertionError(f"{name} QPs of shape {q64[1].shape}")
        out[name] = compare_solve(kernel, plain, q64, args, n_out,
                                  f"{name} (7, 8)")
        if name == "K5" and not out[name]["float64_bit_identical"]:
            raise AssertionError("float64 K5 (7, 8) on lanes is not the "
                                 "plain version's bit for bit")
        if name == "K5":
            out[name].update(solve_timing(
                kernel, plain, tuple(t.float() for t in q64), args, 2,
                count=lambda q: host_model_terms().warm_solve_count(
                    *q, *args, threads=os.cpu_count() or 1)))
    for name, source, kernel in (
            ("K5", "warm_hybrid_solve_nv7_k8_", "warm_hybrid_solve_kernel"),
            ("K4", "cold_hybrid_solve_nv7_k8_", "cold_hybrid_solve_kernel")):
        for key, mangled in (("ptxas", "IfLi7ELi8E"),
                             ("ptxas_float64", "IdLi7ELi8E")):
            out[name][key] = ptxas_lines(source, kernel + mangled)
    out["K5"]["design"] = K5_DESIGN
    emit({"phase": "elbow_kernel_vs_plain", "B": B, **out})
    return out


def phase_k4_contact_rich(cube, elbow) -> dict:
    """K4 on its contact-rich sets: the QPs of the box cube's (6, 4) and
    the elbow's (7, 8) fused rollouts near the ground, at the main path's
    batch of K4 at each size (K4_RICH_B), solved at the cold loss's budget
    (the ICNN models' QPs at initial parameters have no contact). At each
    size: against its plain version at 8,192 QPs and at the ragged
    K5_RAGGED_B (the first of them), float64 bit for bit with equal valid
    masks, float32 by the K5 rule; on the whole set against the plain
    version over chunks (``cold_solve_vs_plain_full``); its times there in
    both types, the plain version's at 8,192, its bound in each type from
    the operations its own body needs on these QPs (counted on the first
    COUNT_B), the shares of QPs with contact and of its loops' iterations
    that were fixed points, its design and ptxas's lines. Reports every
    reading before it raises; returns the readings by size."""
    import numpy as np
    import torch
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.ops import soa_kernels
    kernel = soa_kernels.solve_contact_impulse_soa_cuda_packed
    plain = soa_kernels.plain_packed_cold
    args = (LOSS_EPS, *COLD_BUDGET)
    out, failures = {}, []
    for shape, system in (("nv6_k4", cube), ("nv7_k8", elbow)):
        n = K4_RICH_B[shape]
        x0 = (torch.tensor(assets.cube_states_near_ground(
            np.random.default_rng(0), n), dtype=torch.float64,
            device=system.device) if shape == "nv6_k4" else
              states_near_ground(system, n, 4))
        qps64 = rollout_qps(system, system.initial_params(torch.float64),
                            x0)[:3]
        del x0
        entry = {"B": n, "checks": []}
        for b in (B, *K5_RAGGED_B):
            name = f"K4 {shape} at {b}"
            try:
                c = compare_solve(kernel, plain, tuple(
                    t[..., :b].contiguous() for t in qps64), args, 1, name)
            except AssertionError as exc:
                failures.append(str(exc))
                continue
            if not c["float64_bit_identical"]:
                failures.append(f"float64 {name} is not the plain "
                                f"version's bit for bit")
            entry["checks"].append(c)
        qps32 = tuple(t.float() for t in qps64)
        del qps64
        torch.cuda.empty_cache()
        try:
            cold_solve_vs_plain_full(qps32, f"k4_contact_rich_full_{shape}")
        except AssertionError as exc:
            failures.append(str(exc))
        with torch.no_grad():
            force = kernel(*qps32, *args)[0]
        entry["contact_share"] = force.abs().amax(dim=(0, 1)).gt(0).float() \
            .mean().item()
        del force
        entry.update(solve_timing(kernel, plain, qps32, args, 2,
                                  count=k4_count, plain_b=B))
        entry.update({"count_B": min(COUNT_B, n),
                      "exits": k4_exit_readings(qps32),
                      "design": K4_DESIGN[shape], **k4_ptxas(shape)})
        out[shape] = entry
        del qps32
        torch.cuda.empty_cache()
    emit({"phase": "k4_contact_rich", "budget": list(COLD_BUDGET),
          "failures": failures, **out})
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def phase_elbow_rollout(system, x0_64):
    """``simulate_batch`` of the elbow over B trajectories x ELBOW_STEPS in
    float32 (K5 at (7, 8) every step), K5's launches read around that run;
    the first CHECK_STEPS steps of CHECK_TRAJ trajectories in float64 on
    the card and on the CPU."""
    import torch
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    params = system.initial_params(torch.float32)
    x0 = x0_64.float()
    system.simulate_batch(params, x0[:1024], 2)          # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    traj = system.simulate_batch(params, x0, ELBOW_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches_by()
    if tuple(traj.shape) != (B, ELBOW_STEPS + 1, 15):
        raise AssertionError(f"elbow trajectory shape {tuple(traj.shape)}")
    if launches["K5"] != {"nv7_k8": ELBOW_STEPS}:
        raise AssertionError(f"launches {launches} in a {ELBOW_STEPS}-step "
                             "elbow rollout")
    # Float32 trajectories that leave the finite numbers are decided
    # against float64: at most ELBOW_DIVERGED_SHARE of the batch, and each
    # finite over the whole rollout in float64 on the card.
    diverged = (~torch.isfinite(traj).all(dim=-1).all(dim=-1)).nonzero() \
        .flatten()
    n_diverged = int(diverged.numel())
    if n_diverged > ELBOW_DIVERGED_SHARE * B:
        raise AssertionError(f"{n_diverged} of {B} float32 elbow "
                             f"trajectories are not finite")
    if n_diverged:
        referee = system.simulate_batch(
            system.initial_params(torch.float64), x0_64[diverged],
            ELBOW_STEPS, use_fused=True)
        if not bool(torch.isfinite(referee).all()):
            raise AssertionError("float64 reruns of the diverged float32 "
                                 "elbow trajectories are not finite")
    x_check = x0_64[:CHECK_TRAJ]
    gpu = system.simulate_batch(system.initial_params(torch.float64),
                                x_check, CHECK_STEPS, use_fused=True)
    cpu_system = MultibodyLearnableSystem(system.model, DT, device="cpu")
    cpu = cpu_system.simulate_batch(cpu_system.initial_params(torch.float64),
                                    x_check.cpu(), CHECK_STEPS,
                                    use_fused=True)
    check_err = (gpu.cpu() - cpu).abs().max().item()
    if not check_err <= ROLLOUT_ATOL:
        raise AssertionError(f"float64 elbow rollout on the card differs "
                             f"from the CPU by {check_err:.3e}")
    emit({"phase": "elbow_rollout", "B": B, "steps": ELBOW_STEPS,
          "dtype": "float32", "seconds": seconds,
          "steps_per_s": ELBOW_STEPS / seconds,
          "transitions_per_s": B * ELBOW_STEPS / seconds,
          "launches": launches,
          "float64_card_vs_cpu_max_abs_err": check_err,
          "float32_diverged": n_diverged,
          "float32_diverged_first": diverged[:8].tolist()})
    return launches["K5"]["nv7_k8"]


def loss_card_vs_cpu(system, x, x_plus, phase: str, extra: dict,
                     expected: dict):
    """The cold and warm float64 loss and every leaf's gradient of
    transitions ``(x, x_plus)`` on the card against the CPU at the same
    parameters (``icnn_loss_readings``): losses within rtol LOSS_RTOL,
    atol LOSS_ATOL, gradients within rtol GRAD_RTOL, atol CPU_GRAD_ATOL,
    and the card's launches by instantiation as ``expected`` says. Reports
    every reading before it raises."""
    import torch
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    cpu_system = MultibodyLearnableSystem(system.model, DT, device="cpu")
    params_cpu = cpu_system.initial_params(torch.float64)
    reset_launches()
    card = icnn_loss_readings(system, params_to(params_cpu, system.device),
                              x, x_plus)
    launches = read_launches_by()
    cpu = icnn_loss_readings(cpu_system, params_cpu, x.cpu(), x_plus.cpu())
    failures, result = [], {}
    for name in ("cold", "warm"):
        got, ref = card[f"{name}_loss"], cpu[f"{name}_loss"]
        result[f"{name}_loss_max_abs_err"] = (got - ref).abs().max().item()
        if not torch.allclose(got, ref, rtol=LOSS_RTOL, atol=LOSS_ATOL):
            failures.append(f"{name} loss differs by "
                            f"{result[f'{name}_loss_max_abs_err']:.3e}")
        errs = []
        for i, (g, r) in enumerate(zip(card[f"{name}_grad"],
                                       cpu[f"{name}_grad"])):
            if (g is None) != (r is None):
                failures.append(f"{name} gradient of leaf {i}: card "
                                f"{g is not None}, CPU {r is not None}")
                continue
            errs.append(None if g is None else (g - r).abs().max().item())
            if g is not None and not torch.allclose(
                    g, r, rtol=GRAD_RTOL, atol=CPU_GRAD_ATOL):
                failures.append(f"{name} gradient of leaf {i} differs by "
                                f"{errs[-1]:.3e}")
        result[f"{name}_grad_max_abs_err_per_leaf"] = errs
    for name in ("seed_force", "warm_force"):
        result[f"{name}_max_abs_err"] = (
            card[name] - cpu[name]).abs().max().item()
    if {name: launches[name] for name in expected} != expected:
        failures.append(f"launches {launches} on the card, expected "
                        f"{expected}")
    emit({"phase": phase, "B": x.shape[0], "dtype": "float64",
          "launches": launches, "failures": failures, **extra,
          "max_abs_loss": cpu["cold_loss"].abs().max().item(),
          "max_abs_impulse": cpu["seed_force"].abs().max().item(), **result})
    if failures:
        raise AssertionError("; ".join(failures))


def phase_elbow_icnn_loss(system, x0_icnn):
    """The ICNN elbow's cold and warm loss through the training entry
    points at ELBOW_ICNN_B transitions of the elbow's training recipe,
    float32, with K4's and K5's launches (one each, at (7, 8)); K4 on the
    QPs that run's cold loss hands it against its plain version over
    chunks (``cold_solve_vs_plain_full``), and its times and bound there;
    then the float64 loss and every leaf's gradient on 16 transitions (8
    of that batch, 8 steps 3 to 4 of the ICNN elbow's rollout near the
    ground) on the card against the CPU. Returns the launches of the
    float32 run and K4's readings."""
    from dair_pll_tpu_torch.ops import soa_kernels
    import torch
    x, x_plus = elbow_train_transitions(ELBOW_ICNN_B, system.device)
    params = system.initial_params(torch.float32)
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    u = x.new_zeros((x.shape[0], 0))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cold = torch.mean(system.contactnets_loss_batch(params, x, u, x_plus))
    cold.backward()
    with torch.no_grad():
        _, seed = system.contactnets_loss_batch_warm(
            params, x, u, x_plus,
            x.new_zeros((3, system.model.n_contacts, x.shape[0])),
            budget=COLD_BUDGET)
    warm, _ = system.contactnets_loss_batch_warm(params, x, u, x_plus, seed)
    torch.mean(warm).backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches_by()
    expected = {"K1": {}, "K3": {}, "K2": {}, "K4": {"nv7_k8": 1},
                "K5": {"nv7_k8": 2}, "K6": {}}
    if launches != expected or not bool(torch.isfinite(cold)):
        raise AssertionError(f"ICNN elbow loss: launches {launches}, "
                             f"loss {cold.item()}")
    qps32 = cold_loss_qps(system, params, x, x_plus)
    err32, err64 = cold_solve_vs_plain_full(qps32,
                                            "elbow_icnn_kernel_vs_plain_full")
    k4 = {"B": x.shape[0], "max_abs_err": err32, "max_abs_err_float64": err64,
          **solve_timing(soa_kernels.solve_contact_impulse_soa_cuda_packed,
                         soa_kernels.plain_packed_cold, qps32,
                         (LOSS_EPS, *COLD_BUDGET), 2, count=k4_count),
          "count_B": min(COUNT_B, x.shape[0]),
          "exits": k4_exit_readings(qps32), "design": K4_DESIGN["nv7_k8"],
          **k4_ptxas("nv7_k8")}
    emit({"phase": "elbow_icnn_kernel_timing", "dtype": "float32", **k4})
    del qps32
    half = 8
    traj = system.simulate_batch(system.initial_params(torch.float64),
                                 x0_icnn[:half], 4, use_fused=True)
    xc = torch.cat((x[:half].double(), traj[:, 3]))
    xpc = torch.cat((x_plus[:half].double(), traj[:, 4]))
    loss_card_vs_cpu(system, xc, xpc, "elbow_icnn_loss",
                     {"float32_batch": ELBOW_ICNN_B,
                      "float32_cold_loss": cold.item(),
                      "float32_seconds": seconds,
                      "float32_launches": launches},
                     {"K4": {"nv7_k8": 1}, "K5": {"nv7_k8": 2}})
    return launches, k4


def model_transitions(system, x0_64):
    """8,192 float64 transitions of a model's own fused rollout near the
    ground (steps 3 to 4), batch-major."""
    import torch
    traj = system.simulate_batch(system.initial_params(torch.float64),
                                 x0_64, 4, use_fused=True)
    return traj[:, 3].contiguous(), traj[:, 4].contiguous()


def phase_elbow_loss_kernels(systems: dict, x0s: dict):
    """The generic K1 (cold), K3 (warm, from K1's impulses at parameters
    one Adam step on) and K2 against their plain versions on 8,192
    transitions of each model's own float64 rollout: the elbow in boxes
    and in polygons, and the polygon cube (the one-body size); the rules
    of ``loss_kernels_vs_plain``."""
    out, inputs = {}, {}
    for name, system in systems.items():
        x64, xp64 = model_transitions(system, x0s[name])
        out[name], pvec = compare_loss_kernels(system, x64, xp64)
        inputs[name] = (x64, xp64, pvec)
    emit({"phase": "elbow_loss_kernels_vs_plain", "B": B, **out})
    return out, inputs


def k4_exits(dtype, exits="card"):
    """K4's exits for the host count (``cold_solve_count``): as the card
    runs them in ``dtype`` (``"card"``: SAP-Newton's, in float64 the IPM's
    too, ``kColdIpmExits`` of ``csrc/cold_hybrid_solve.cuh``), or as
    given."""
    import torch
    if exits != "card":
        return exits
    return True if dtype == torch.float64 else "newton"


def k4_count(qps, exits="card") -> dict:
    """K4's own body (``hybrid_solve.cuh``'s ``cold_solve_packed``, its
    fixed-point exits as the card runs them, or ``exits`` as
    ``cold_solve_count`` takes them) counted by the host build on the
    first COUNT_B of the packed QPs ``(m, jc, qc)``, in their dtype, at
    the cold loss's budget: the tallies scaled to the batch."""
    n = qps[0].shape[-1]
    m = min(COUNT_B, n)
    c = host_model_terms().cold_solve_count(
        *(t[..., :m].cpu() for t in qps[:3]), LOSS_EPS, *COLD_BUDGET,
        threads=os.cpu_count() or 1, exits=k4_exits(qps[0].dtype, exits))
    return {key: value * n / m for key, value in c.items()}


def exit_readings(count, n: int, budget) -> dict:
    """The exact fixed points of a cold solve over n samples in each type
    (``count(dtype, exits)``: the host build's tallies of its body with
    exits ``"card"``, as the kernel runs them, True, both loops', or
    False, none): the shares of the IPM and Newton iterations that
    repeated the one before, and the operations the body needs with the
    kernel's exits, with both loops' and with none."""
    import torch
    out = {}
    for dtype in (torch.float32, torch.float64):
        card, both, off = (count(dtype, exits)
                           for exits in ("card", True, False))
        out[str(dtype).split(".")[1]] = {
            "ipm_fixed_share": both["ipm_fixed"] / (n * budget[0]),
            "newton_fixed_share": both["newton_fixed"] / (n * budget[1]),
            "operations_per_sample": card["needed"] / n,
            "operations_per_sample_both_exits": both["needed"] / n,
            "operations_per_sample_without_exits": off["needed"] / n,
            "operations_ratio": card["needed"] / off["needed"]}
    return out


def k4_exit_readings(qps) -> dict:
    """``exit_readings`` of K4 on the packed QPs (counted on the first
    COUNT_B)."""
    return exit_readings(
        lambda dtype, exits: k4_count(tuple(t.to(dtype) for t in qps[:3]),
                                      exits),
        qps[0].shape[-1], COLD_BUDGET)


def k4_ptxas(shape: str) -> dict:
    """ptxas's lines of K4 at a size (``nv6_k4``, ``nv7_k8``) in float32
    and float64: on 4 lanes, on one thread and on other lanes a QP, as
    built."""
    n_v, k = shape[2], shape[5]
    out = {}
    for key, t in (("ptxas", "f"), ("ptxas_float64", "d")):
        name = f"cold_hybrid_solve_kernelI{t}Li{n_v}ELi{k}E"
        for lanes in range(1, 33):
            lines = ptxas_lines("cold_hybrid_solve_", f"{name}Li{lanes}E")
            if lines:
                out[key if lanes == 4 else f"{key}_one_thread" if lanes == 1
                    else f"{key}_lanes{lanes}"] = lines
        if not out.get(key) and not out.get(f"{key}_one_thread"):
            # A kernel that takes no lanes argument: one thread a QP.
            out[f"{key}_one_thread"] = ptxas_lines("cold_hybrid_solve_",
                                                   name + "E")
    return out


#: The host builds of the kernels' device code for their bounds (``g++``,
#: ``ops/host_adjoint.py``), started together in threads after the kernels'
#: build, so that they compile beside the card's work.
_HOST_BUILDS = {}


def start_host_builds() -> None:
    """Starts the host builds: the loss kernels' and K4/K5's bodies at the
    default sizes (``HostModelTerms``), at ``size_cover``'s sizes, and the
    box cube's K2 sweep (``HostAdjoint``)."""
    import concurrent.futures
    from dair_pll_tpu_torch.ops import host_adjoint
    if _HOST_BUILDS:
        return
    pool = concurrent.futures.ThreadPoolExecutor(3)
    build = os.path.join(HERE, "build")
    _HOST_BUILDS.update(
        model_terms=pool.submit(host_adjoint.HostModelTerms,
                                os.path.join(build, "host_model_terms"),
                                *host_sizes(DEFAULT_HOST_MODELS)),
        size_cover=pool.submit(
            host_adjoint.HostModelTerms,
            os.path.join(build, "host_size_cover"),
            *host_sizes(tuple(SIZE_URDFS))),
        adjoint=pool.submit(host_adjoint.HostAdjoint,
                            os.path.join(build, "host_adjoint")))
    pool.shutdown(wait=False)


def host_build(name: str):
    """A host build of :func:`start_host_builds` (started if need be),
    once it is done."""
    start_host_builds()
    return _HOST_BUILDS[name].result()


def host_model_terms():
    """The host build of the loss kernels' forward bodies and their counts
    (``host_adjoint.HostModelTerms``), once a run."""
    return host_build("model_terms")


def host_counts(model, pvec, xin, xp, force, valid, ct, fprev) -> dict:
    """Operations the generic K1, K3 and K2 need on the first COUNT_B
    samples of a batch, scaled to the batch: ``{"K1": ..., "K3": ...,
    "K2": ...}`` and the count's seconds. K1's and K3's are their own
    code's (``host_adjoint.HostModelTerms``' counting build, in the
    batch's type). K2's is the smaller of two counts of the same gradient:
    its own code's, one reverse-mode sweep a sample without the forward
    terms it computes a second time, and torch autograd's
    (``plain_loss_bwd``) pointwise operations and reductions
    (``host_adjoint.count_torch_operations``); ``"K2"`` also holds both as
    ``"own"`` and ``"autograd"``. Each kind's ``"recomputed"`` is that
    second time's count (K2's only), in ``"executed"``."""
    from dair_pll_tpu_torch.ops import host_adjoint
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    host = host_for(model)
    n = xin.shape[1]
    cols = slice(0, min(COUNT_B, n))
    sub = [t[..., cols] for t in (xin, xp, force, valid, ct, fprev)]
    t0 = time.perf_counter()
    counts = {}
    for name, kind, fin, budget in (("K1", "cold", None, COLD_BUDGET),
                                    ("K3", "warm", sub[5], WARM_BUDGET),
                                    ("K2", "vjp", sub[2], COLD_BUDGET)):
        c = host.count(kind, model, pvec, sub[0], sub[1], fin, sub[3],
                       sub[4], DT, LOSS_EPS, *budget,
                       threads=os.cpu_count() or 1)
        scale = n / sub[0].shape[1]
        counts[name] = {what: c[what] * scale
                        for what in ("needed", "executed", "recomputed")}
    counts["K2"]["needed"] += pvec.numel() * (n - 1)   # the batch sum
    autograd = host_adjoint.count_torch_operations(lambda: lk.plain_loss_bwd(
        model, pvec, *sub[:5], DT, LOSS_EPS)) * scale
    counts["K2"].update(own=counts["K2"]["needed"], autograd=autograd,
                        needed=min(counts["K2"]["needed"], autograd))
    counts["seconds"] = time.perf_counter() - t0
    return counts


def generic_loss_timing(system, pvec, xin_t, xp_t, small, reps: int,
                        with_float64: bool) -> dict:
    """The generic K1, K3 and K2 at a batch (float32; K2 also in float64
    with ``with_float64``), their plain versions at 8,192 (``small``:
    ``(xin, xp)``), and their bounds from the operations their own code
    needs on this batch (``host_counts``) and the bytes they move."""
    import torch
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    model = system.model
    n = xin_t.shape[1]
    ct_t = torch.ones_like(xin_t[0])
    xin_s, xp_s = small
    ct_s = torch.ones_like(xin_s[0])
    cold = lk.fused_loss_fwd(model, pvec, xin_t, xp_t, DT, LOSS_EPS,
                             *COLD_BUDGET)
    cold_s = lk.fused_loss_fwd(model, pvec, xin_s, xp_s, DT, LOSS_EPS,
                               *COLD_BUDGET)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    calls = {
        "K1": (lambda: lk.fused_loss_fwd(model, pvec, xin_t, xp_t, DT,
                                         LOSS_EPS, *COLD_BUDGET),
               lambda: lk.plain_loss_fwd(model, pvec, xin_s, xp_s, DT,
                                         LOSS_EPS, *COLD_BUDGET),
               nbytes(pvec, xin_t, xp_t, *cold)),
        "K3": (lambda: lk.fused_loss_fwd_warm(model, pvec, xin_t, xp_t,
                                              cold[1], DT, LOSS_EPS,
                                              *WARM_BUDGET),
               lambda: lk.plain_loss_fwd_warm(model, pvec, xin_s, xp_s,
                                              cold_s[1], DT, LOSS_EPS,
                                              *WARM_BUDGET),
               nbytes(pvec, xin_t, xp_t, cold[1], *cold)),
        "K2": (lambda: lk.fused_loss_bwd(model, pvec, xin_t, xp_t, cold[1],
                                         cold[2], ct_t, DT, LOSS_EPS),
               lambda: lk.plain_loss_bwd(model, pvec, xin_s, xp_s,
                                         cold_s[1], cold_s[2], ct_s, DT,
                                         LOSS_EPS),
               nbytes(pvec, xin_t, xp_t, cold[1], cold[2], ct_t, pvec,
                      xin_t, xp_t)),
    }
    counts = host_counts(model, pvec, xin_t, xp_t, cold[1], cold[2], ct_t,
                         cold[1])
    result = {"count_seconds": counts.pop("seconds"),
              "count_B": min(COUNT_B, n)}
    for name, (kernel, plain, n_bytes) in calls.items():
        ms = cuda_ms(kernel, reps=reps, warmup=1)
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        ops = counts[name]["needed"]
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS_PER_S["float32"] * 1e3
        result[name] = {
            "ms": ms, "plain_ms": plain_ms, "plain_B": xin_s.shape[1],
            "bytes": n_bytes, "operations": ops,
            "operations_per_sample": ops / n,
            "operations_executed": counts[name]["executed"],
            **({"operations_own": counts[name]["own"],
                "operations_autograd": counts[name]["autograd"],
                "operations_recomputed": counts[name]["recomputed"]}
               if name == "K2" else {}),
            "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    result["valid_share"] = cold[2].float().mean().item()
    if with_float64:
        k2 = result["K2"]
        p_d, xin_d, xp_d, force_d, ct_d = (
            t.double() for t in (pvec, xin_t, xp_t, cold[1], ct_t))
        k2["ms_float64"] = cuda_ms(
            lambda: lk.fused_loss_bwd(model, p_d, xin_d, xp_d, force_d,
                                      cold[2], ct_d, DT, LOSS_EPS),
            reps=max(1, reps // 2), warmup=1)
        result["K1"]["ms_float64"] = cuda_ms(
            lambda: lk.fused_loss_fwd(model, p_d, xin_d, xp_d, DT, LOSS_EPS,
                                      *COLD_BUDGET),
            reps=max(1, reps // 2), warmup=1)
        result["K3"]["ms_float64"] = cuda_ms(
            lambda: lk.fused_loss_fwd_warm(model, p_d, xin_d, xp_d, force_d,
                                           DT, LOSS_EPS, *WARM_BUDGET),
            reps=max(1, reps // 2), warmup=1)
        c64 = host_counts(model, p_d, xin_d, xp_d, force_d, cold[2], ct_d,
                          force_d)
        # In: pvec, xin, xp (K3 also fprev); out: loss, force, valid.
        outs64 = nbytes(force_d, cold[2]) + n * 8
        for name, n_bytes in (
                ("K1", nbytes(p_d, xin_d, xp_d) + outs64),
                ("K3", nbytes(p_d, xin_d, xp_d, force_d) + outs64)):
            entry = result[name]
            b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            o_ms = c64[name]["needed"] / PEAK_OPS_PER_S["float64"] * 1e3
            entry["operations_float64"] = c64[name]["needed"]
            entry["bound_ms_float64"] = max(b_ms, o_ms)
            entry["bound_by_float64"] = "bytes" if b_ms >= o_ms else \
                "operations"
        bytes64_ms = nbytes(p_d, xin_d, xp_d, force_d, cold[2], ct_d, p_d,
                            xin_d, xp_d) / HBM_BYTES_PER_S * 1e3
        ops64_ms = c64["K2"]["needed"] / PEAK_OPS_PER_S["float64"] * 1e3
        k2["operations_float64"] = c64["K2"]["needed"]
        k2["operations_float64_own"] = c64["K2"]["own"]
        k2["operations_float64_autograd"] = c64["K2"]["autograd"]
        k2["bound_ms_float64"] = max(bytes64_ms, ops64_ms)
        k2["bound_by_float64"] = ("bytes" if bytes64_ms >= ops64_ms
                                  else "operations")
        del p_d, xin_d, xp_d, force_d, ct_d
    return result


def budget_timing(model, pvec, xin, xp, fprev, reps: int) -> dict:
    """K1 and K3 (the box cube's, or the generic ones) on one batch at
    each (ipm, newton) budget of
    SOLVE_BUDGETS (K3 warm-started from ``fprev``), in ms, and each one's
    time split into the terms and assembly (the (0, 0) budget), an IPM
    iteration (((10, 0) - (0, 0)) / 10) and a Newton iteration (((10, 10)
    - (10, 0)) / 10)."""
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    times = {}
    for ipm, newton in SOLVE_BUDGETS:
        times[f"{ipm},{newton}"] = {
            "K1": cuda_ms(lambda i=ipm, n=newton: lk.fused_loss_fwd(
                model, pvec, xin, xp, DT, LOSS_EPS, i, n), reps, warmup=1),
            "K3": cuda_ms(lambda i=ipm, n=newton: lk.fused_loss_fwd_warm(
                model, pvec, xin, xp, fprev, DT, LOSS_EPS, i, n), reps,
                warmup=1)}
    split = {}
    for name in ("K1", "K3"):
        t = {budget: times[budget][name] for budget in times}
        split[name] = {"terms_ms": t["0,0"],
                       "ipm_iteration_ms": (t["10,0"] - t["0,0"]) / 10,
                       "newton_iteration_ms": (t["10,10"] - t["10,0"]) / 10}
    return {"ms": times, "split": split}


def phase_elbow_loss_timing(system, transitions, x_train, xp_train):
    """The generic K1, K3 and K2 at the elbow's training batch
    (2,097,152, float32; also in float64), the plain versions at 8,192,
    bounds, K1's and K3's times at each budget of SOLVE_BUDGETS, and
    ptxas's lines at both types; then the three against their plain
    versions over chunks of the batch's first ELBOW_SLICE transitions."""
    import torch
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    x64, xp64, pvec = transitions
    small = (x64.T.float().contiguous(), xp64.T.float().contiguous())
    xin_t, xp_t = x_train.T.contiguous(), xp_train.T.contiguous()
    result = generic_loss_timing(system, pvec, xin_t, xp_t, small, reps=3,
                                 with_float64=True)
    fprev = lk.fused_loss_fwd(system.model, pvec, xin_t, xp_t, DT, LOSS_EPS,
                              *COLD_BUDGET)[1]
    result["budgets"] = budget_timing(system.model, pvec, xin_t, xp_t,
                                      fprev, reps=3)
    del fprev
    for name, lines in loss_ptxas("b2_q8_v7_k8").items():
        result[name].update(lines)
    emit({"phase": "elbow_loss_kernel_timing", "B": xin_t.shape[1],
          "dtype": "float32", **result})
    sliced = phase_loss_full_batch(
        system, pvec, x_train[:ELBOW_SLICE], xp_train[:ELBOW_SLICE],
        chunks=(ELBOW_PLAIN_CHUNK, ELBOW_PLAIN_CHUNK // 2),
        phase="elbow_loss_kernels_vs_plain_slice")
    del small
    torch.cuda.empty_cache()
    return result, sliced


def loss_ptxas(size: str) -> dict:
    """ptxas's register and spill lines of the generic K1, K3 and K2 at one
    size (``b1_q7_v6_k4``, ``b2_q8_v7_k8``) in float32 and float64: ``{"K1": {"ptxas":
    [...], "ptxas_float64": [...]}, ...}``; K1's and K3's lines are their
    lanes' kernel's, then the terms kernel's they launch first (or, at
    one thread a sample, their one kernel's)."""
    out = {}
    for name, kernels in (
            ("K1", ("model_loss_fwd_kernel", "model_loss_fwd_lanes_kernel",
                    "model_loss_terms_kernel")),
            ("K3", ("model_loss_fwd_warm_kernel",
                    "model_loss_fwd_warm_lanes_kernel",
                    "model_loss_terms_kernel"))):
        out[name] = {
            key: [line for kernel in kernels
                  for line in ptxas_lines(f"contactnets_loss_fwd_{size}_f",
                                          kernel + mangled)]
            for key, mangled in (("ptxas", "If"), ("ptxas_float64", "Id"))}
    out["K2"] = {key: ptxas_lines(f"contactnets_loss_bwd_{size}_{suffix}",
                                  "model_loss_bwd_kernel")
                 for key, suffix in (("ptxas", "f32"),
                                     ("ptxas_float64", "f64"))}
    return out


def phase_generic_train(system, x, x_plus, phase: str, size: str):
    """``TrainingRun`` (a cold step, the cache's seed, WARM_STEPS warm
    steps, Adam) of a model the generic loss kernels cover, with a trace
    of one warm step; the launches of the timed round, all at ``size``."""
    run = TrainingRun(system, x, x_plus)
    report, cache = run.timed()
    if not all(run.moved()):
        raise AssertionError(f"{phase}: a parameter tensor did not move")
    launches = read_launches_by()
    expected = {"K1": {size: 1}, "K3": {size: 1 + WARM_STEPS},
                "K2": {size: 1 + WARM_STEPS}, "K4": {}, "K5": {}, "K6": {}}
    if launches != expected:
        raise AssertionError(f"{phase}: launches {launches}, expected "
                             f"{expected}")
    emit({"phase": phase, **report, "launches_by": launches,
          "profiled_warm_step": profile_step(
              lambda: run.warm_step(cache),
              report["warm_step_median_ms"] / 1e3)})
    return report["launches"]


def phase_polygon_train(system):
    """The polygon cube (the generic kernels' one-body size) trained on
    POLYGON_TRAIN_B transitions of the cube's recipe, then its kernels'
    times at that batch (K2 also in float64), plain times at 8,192 and
    bounds."""
    import torch
    x, x_plus = train_transitions(POLYGON_TRAIN_B, system.device)
    launches = phase_generic_train(system, x, x_plus, "polygon_cube_train",
                                   "b1_q7_v6_k4")
    pvec = derived_vector(system, system.initial_params(torch.float32))
    small = tuple(t[:, :B].contiguous() for t in (x.T, x_plus.T))
    timing = generic_loss_timing(system, pvec, x.T.contiguous(),
                                 x_plus.T.contiguous(), small, reps=5,
                                 with_float64=True)
    for name, lines in loss_ptxas("b1_q7_v6_k4").items():
        timing[name].update(lines)
    emit({"phase": "polygon_cube_kernel_timing", "B": POLYGON_TRAIN_B,
          "dtype": "float32", **timing})
    return launches, timing


# -- every size the TPU kernels take (phase 14) ----------------------------------

#: The models of ``size_cover``: a ball (one free body, a sphere: (n_v,
#: k) = (6, 1)) and a box and a sphere on one body (witnesses 4 + 1,
#: (6, 5)), as ``tests/test_urdf_features.py`` writes them.
SIZE_URDFS = {
    "ball": """<robot name="ball"><link name="ball">
  <inertial><mass value="0.3"/><inertia ixx="0.0003" iyy="0.0003"
    izz="0.0003" ixy="0" ixz="0" iyz="0"/></inertial>
  <collision><geometry><sphere radius="0.05"/></geometry></collision>
</link></robot>""",
    "box_sphere": """<robot name="box_sphere"><link name="body">
  <inertial><origin xyz="0 0 0" rpy="0 0 0"/><mass value="0.5"/>
    <inertia ixx="0.002" iyy="0.003" izz="0.004" ixy="0" ixz="0"
      iyz="0"/></inertial>
  <collision><origin xyz="0.1 0 0" rpy="0 0 0"/>
    <geometry><box size="0.1 0.2 0.3"/></geometry></collision>
  <collision><origin xyz="-0.1 0 0" rpy="0 0 0"/>
    <geometry><sphere radius="0.05"/></geometry></collision>
</link></robot>"""}
#: Float32 rollouts of the new sizes may leave the finite numbers, as the
#: JAX package's do (``tests/test_torch_size_cover.py``'s slow
#: ``test_float32_divergence_is_the_references``: on all 8,192 states of
#: each model, JAX run op by op, rounding each operation as the port does,
#: lost 174 of the box and sphere body's and none of the ball's). The
#: limit is that count plus three standard deviations of the difference
#: of two such counts (3 sqrt(2 x 174) = 56), and each such trajectory
#: must stay finite in float64.
SIZE_DIVERGED_SHARE = 230 / 8192
SIZE_TRAIN_B = 2097152
SIZE_ROLLOUT_STEPS = 128
#: A free body with a prism over a WIDE_POLYGON_SIDES-gon (twice that many
#: vertices, as a polygon) and a sphere: the box and sphere body's
#: witnesses (4 + 1) at a size whose K2 gradient columns would take more
#: than ``kBwdGradShared``'s 64 KB a block in both types (132 derived
#: scalars at most), so that K2 keeps them in the thread's stack. At 80
#: vertices the columns would have needed more shared memory than a block
#: has (``scripts/probe_loss_lanes.py --model wide_polygon_80``), but its
#: kernels take minutes to build.
WIDE_POLYGON_SIDES = 10
SIZE_K4_B = 262144
SIZE_PLAIN_CHUNK = 65536
THREE_CUBES_B = 65536
THREE_CUBES_CHECK_B = 8192
THREE_CUBES_STEPS = 8


def prism_obj(sides: int, radius: float = 0.05, half: float = 0.04) -> str:
    """An ``.obj`` of a prism over a regular ``sides``-gon (``2 sides``
    vertices)."""
    rows = [f"v {radius * math.cos(2 * math.pi * i / sides):.9f} "
            f"{radius * math.sin(2 * math.pi * i / sides):.9f} {z:.9f}"
            for z in (-half, half) for i in range(sides)]
    return "\n".join(rows) + "\n"


def wide_polygon_system(device=None, sides: int = WIDE_POLYGON_SIDES):
    """The free body of WIDE_POLYGON_SIDES (its prism over a ``sides``-gon
    a polygon, then a sphere; on the card unless ``device`` says
    otherwise), from a URDF and a mesh the script writes under
    ``build/size_cover/``."""
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    directory = os.path.join(HERE, "build", "size_cover")
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"prism{sides}.obj"), "w",
              encoding="utf-8") as handle:
        handle.write(prism_obj(sides))
    path = os.path.join(directory, f"wide_polygon{sides}.urdf")
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(SIZE_URDFS["box_sphere"].replace(
            '<box size="0.1 0.2 0.3"/>',
            f'<mesh filename="prism{sides}.obj"/>'))
    return MultibodyLearnableSystem.from_urdfs(
        {"wide_polygon": path}, DT, mesh_representation="polygon",
        device=device)


def wide_polygon_readings() -> dict:
    """The free body of WIDE_POLYGON_SIDES: its generic K1, K3 and K2,
    built at first use, against their plain versions on 8,192 transitions
    of its own float64 rollout (``compare_loss_kernels``: K2 launched in
    both types), and the size's designs in each type
    (``soa_loss_kernels.loss_design``), whose K2 keeps each sample's
    gradient in the thread's stack."""
    import torch
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    system = wide_polygon_system()
    size = lk.model_size(system.model)
    x64, xp64 = model_transitions(system, states_near_ground(system, B, 23))
    vs_plain, _ = compare_loss_kernels(system, x64, xp64)
    designs = {str(dtype).split(".")[1]: lk.loss_design(size, dtype)
               for dtype in (torch.float32, torch.float64)}
    if any(d["grad_shared"] for d in designs.values()):
        raise AssertionError(f"{size.name}: K2's gradient columns past "
                             "64 KB a block")
    return {"size": size.name, "vertices": 2 * WIDE_POLYGON_SIDES,
            "n_params": lk.derived_size(system.model),
            "witnesses": list(system.model.contacts_per_pair),
            "designs": designs, "loss_kernels_vs_plain": vs_plain}


def size_systems(device=None) -> dict:
    """The ball and the box and sphere body (on the card unless ``device``
    says otherwise), from URDFs the script writes under
    ``build/size_cover/``."""
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    directory = os.path.join(HERE, "build", "size_cover")
    os.makedirs(directory, exist_ok=True)
    systems = {}
    for name, text in SIZE_URDFS.items():
        path = os.path.join(directory, f"{name}.urdf")
        with open(path, "w", encoding="utf-8") as handle:
            handle.write(text)
        systems[name] = MultibodyLearnableSystem.from_urdfs({name: path}, DT,
                                                            device=device)
    return systems


@functools.lru_cache(maxsize=None)
def generic_models() -> dict:
    """The models of the phases that run the generic loss kernels, on the
    CPU, by name: the polygon cube, the elbow in boxes and in polygons,
    the ball, the box and sphere body and the wide polygon."""
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    systems = {
        "cube_polygon": MultibodyLearnableSystem.from_urdfs(
            {"cube": assets.get_asset("cube_mesh")}, DT,
            mesh_representation="polygon", device="cpu"),
        "elbow": elbow_system(device="cpu"),
        "elbow_polygon": elbow_system("elbow_mesh", device="cpu",
                                      mesh_representation="polygon"),
        **size_systems("cpu"),
        "wide_polygon": wide_polygon_system("cpu")}
    return {name: system.model for name, system in systems.items()}


def generic_sizes(names=None) -> list:
    """The generic loss kernels' sizes (``soa_loss_kernels.model_size``)
    of the models ``names`` of :func:`generic_models` (all by default),
    each once, in order."""
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    models = generic_models()
    sizes = {}
    for name in names or models:
        size = lk.model_size(models[name])
        sizes.setdefault(size.name, size)
    return list(sizes.values())


def host_sizes(names) -> tuple:
    """A host build's generic sizes and K4/K5 ``(n_v, k)`` shapes for the
    models ``names`` of :func:`generic_models`."""
    models = generic_models()
    shapes = {(models[name].n_v, models[name].n_contacts): None
              for name in names}
    return generic_sizes(names), tuple(shapes)


def host_for(model):
    """The host build that holds a model's generic size."""
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    default = {size.name for size in generic_sizes(DEFAULT_HOST_MODELS)}
    if lk.generic_size(model) in default:
        return host_model_terms()
    return host_build("size_cover")


def three_cubes_system():
    """Three box cubes (three ``cube`` assets): 12 plane witnesses and one
    contact for each pair of cubes, k = 15."""
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    path = assets.get_asset("cube")
    return MultibodyLearnableSystem.from_urdfs(
        {f"cube_{c}": path for c in "abc"}, DT)


def three_cube_transitions(system, n: int):
    """``bench.py``'s recipe for each of the three cubes (unit
    quaternions, heights 0.06-0.11 m, velocities 0.5 N(0, 1)), the cubes
    0.12 m apart along x, ``x_plus`` a 0.005 perturbation; seeded numpy,
    float32."""
    import numpy as np
    import torch
    model = system.model
    rng = np.random.default_rng(14)
    x = np.zeros((n, model.n_q + model.n_v), dtype=np.float32)
    for body in range(3):
        q0, v0 = model.body_q_offset(body), model.body_v_offset(body)
        quat = rng.standard_normal((n, 4))
        x[:, q0:q0 + 4] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
        x[:, q0 + 4:q0 + 6] = 0.01 * rng.standard_normal((n, 2))
        x[:, q0 + 4] += 0.12 * (body - 1)
        x[:, q0 + 6] = 0.06 + 0.05 * rng.random(n)
        x[:, model.n_q + v0:model.n_q + v0 + 6] = \
            0.5 * rng.standard_normal((n, 6))
    x_plus = x + 0.005 * rng.standard_normal(x.shape).astype(np.float32)
    for body in range(3):
        q0 = model.body_q_offset(body)
        x_plus[:, q0:q0 + 4] /= np.linalg.norm(x_plus[:, q0:q0 + 4], axis=-1,
                                               keepdims=True)
    return (torch.tensor(x, device=system.device),
            torch.tensor(x_plus, device=system.device))


def size_model_readings(name: str, system, seed: int) -> dict:
    """One model of ``size_cover``: the generic K1, K3 and K2 against
    their plain versions on 8,192 transitions of its own float64 rollout
    (``compare_loss_kernels``), K5 on its rollout QPs against plain
    (float64 within TOL64, float32 by the tail rule), the training round
    at SIZE_TRAIN_B (a cold step, the seed, WARM_STEPS warm steps) with
    its launches, the fused rollout of B x SIZE_ROLLOUT_STEPS with K5's,
    and the loss kernels' times and bounds at SIZE_TRAIN_B."""
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    model = system.model
    size = lk.model_size(model)
    shape = f"nv{model.n_v}_k{model.n_contacts}"
    out = {"size": size.name, "solve_shape": shape,
           "witnesses": list(model.contacts_per_pair)}
    x0_64 = states_near_ground(system, B, seed)
    x64, xp64 = model_transitions(system, x0_64)
    out["loss_kernels_vs_plain"], pvec = compare_loss_kernels(system, x64,
                                                              xp64)
    qps = rollout_qps(system, system.initial_params(torch.float64), x0_64)
    args = (EPS, *BUDGET)
    out["K5_vs_plain"] = compare_solve(
        soa_kernels.solve_warm_hybrid_soa_cuda_packed,
        soa_kernels.plain_packed, qps, args, 2, f"K5 {shape}")
    # The training round.
    x, x_plus = train_transitions(SIZE_TRAIN_B, system.device)
    run = TrainingRun(system, x, x_plus)
    report, _ = run.timed()
    if not all(run.moved()):
        raise AssertionError(f"{name}: a parameter tensor did not move")
    launches = read_launches_by()
    expected = {"K1": {size.name: 1}, "K3": {size.name: 1 + WARM_STEPS},
                "K2": {size.name: 1 + WARM_STEPS}, "K4": {}, "K5": {},
                "K6": {}}
    if launches != expected:
        raise AssertionError(f"{name} training: launches {launches}, "
                             f"expected {expected}")
    out["train"] = {**report, "launches_by": launches}
    # The fused rollout.
    params = system.initial_params(torch.float32)
    system.simulate_batch(params, x0_64[:1024].float(), 2)      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    traj = system.simulate_batch(params, x0_64.float(), SIZE_ROLLOUT_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rollout_launches = read_launches_by()
    if rollout_launches["K5"] != {shape: SIZE_ROLLOUT_STEPS}:
        raise AssertionError(f"{name} rollout: launches {rollout_launches}")
    # Float32 trajectories that leave the finite numbers are decided
    # against float64, as the elbow's: at most SIZE_DIVERGED_SHARE of the
    # batch, each finite over the whole rollout in float64 on the card.
    diverged = (~torch.isfinite(traj).all(dim=-1).all(dim=-1)).nonzero() \
        .flatten()
    finite = 1.0 - diverged.numel() / B
    if diverged.numel() > SIZE_DIVERGED_SHARE * B:
        raise AssertionError(f"{name}: {diverged.numel()} of {B} float32 "
                             f"trajectories are not finite")
    if diverged.numel():
        referee = system.simulate_batch(
            system.initial_params(torch.float64), x0_64[diverged],
            SIZE_ROLLOUT_STEPS, use_fused=True)
        if not bool(torch.isfinite(referee).all()):
            raise AssertionError(f"{name}: float64 reruns of the diverged "
                                 "float32 trajectories are not finite")
    out["rollout"] = {"B": B, "steps": SIZE_ROLLOUT_STEPS,
                      "seconds": seconds,
                      "steps_per_s": SIZE_ROLLOUT_STEPS / seconds,
                      "transitions_per_s": B * SIZE_ROLLOUT_STEPS / seconds,
                      "finite_share": finite,
                      "diverged_float32": diverged.tolist()[:16],
                      "launches_by": rollout_launches}
    # Times and bounds of the loss kernels at the training batch.
    small = tuple(t[:, :B].contiguous() for t in (x.T, x_plus.T))
    xin_t, xp_t = x.T.contiguous(), x_plus.T.contiguous()
    timing = generic_loss_timing(system, pvec, xin_t, xp_t, small, reps=3,
                                 with_float64=True)
    for kernel_name, lines in loss_ptxas(size.name).items():
        timing[kernel_name].update(lines)
        timing[kernel_name]["design"] = generic_design(size.name,
                                                       kernel_name)
    # Where K1's and K3's time goes: the terms, an IPM and a Newton
    # iteration (budget_timing).
    fprev = lk.fused_loss_fwd(model, pvec, xin_t, xp_t, DT, LOSS_EPS,
                              *COLD_BUDGET)[1]
    timing["budgets"] = budget_timing(model, pvec, xin_t, xp_t, fprev,
                                      reps=3)
    del fprev, xin_t, xp_t
    out["loss_timing"] = timing
    # K5's time at the rollout's QPs, its bound from its own body.
    qps32 = tuple(t.float() for t in qps)
    out["K5_timing"] = solve_timing(
        soa_kernels.solve_warm_hybrid_soa_cuda_packed,
        soa_kernels.plain_packed, qps32, args, 2,
        count=lambda q: host_for(model).warm_solve_count(
            *q, *args, threads=os.cpu_count() or 1))
    for key, t in (("ptxas", "f32"), ("ptxas_float64", "f64")):
        out["K5_timing"][key] = ptxas_lines(f"warm_hybrid_solve_{shape}_{t}")
    out["K5_timing"]["build_seconds"] = {
        t: soa_kernels.build_readings().get(
            f"warm_hybrid_solve_{shape}_{t}", {}).get("seconds")
        for t in ("f32", "f64")}
    return out


def ball_cold_solve(system) -> dict:
    """K4 at the ball's (6, 1): the ball's cold loss through its plain
    terms (``soa_terms.soa_contactnets_loss``, whose detached solve is K4)
    at SIZE_K4_B training transitions, its launches; then K4 on the QPs
    that loss hands it against its plain version over chunks, float64
    within TOL64 with equal masks, float32 by the tail rule; its times,
    the plain version's at 8,192 and its bound from its own body's
    count."""
    import torch
    from dair_pll_tpu_torch.multibody.learnable_system import LOSS_EPSILON
    from dair_pll_tpu_torch.multibody.soa_terms import soa_contactnets_loss
    from dair_pll_tpu_torch.ops import soa_kernels
    model = system.model
    params = system.initial_params(torch.float32)
    x, x_plus = train_transitions(SIZE_K4_B, system.device)
    u = x.new_zeros((x.shape[0], 0))
    solve = soa_kernels.solve_contact_impulse_soa_cuda_packed
    captured = []

    def capture(m, jc, qc, *args):
        captured.append((m, jc, qc))
        return solve(m, jc, qc, *args)

    reset_launches()
    soa_kernels.solve_contact_impulse_soa_cuda_packed = capture
    try:
        with torch.no_grad():
            loss, _, _ = soa_contactnets_loss(
                model, params, x, u, x_plus, DT, LOSS_EPSILON,
                *COLD_BUDGET)
        torch.cuda.synchronize()
    finally:
        soa_kernels.solve_contact_impulse_soa_cuda_packed = solve
    launches = read_launches_by()
    if launches["K4"] != {"nv6_k1": 1} or len(captured) != 1:
        raise AssertionError(f"the ball's cold loss: launches {launches}")
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError("the ball's cold loss is not finite")
    qps32 = captured[0]
    args = (LOSS_EPSILON, *COLD_BUDGET)
    kernel, plain = (soa_kernels.solve_contact_impulse_soa_cuda_packed,
                     soa_kernels.plain_packed_cold)

    def plain_chunks(m, jc, qc, *a):
        parts = [plain(m[..., s:s + SIZE_PLAIN_CHUNK].contiguous(),
                       jc[..., s:s + SIZE_PLAIN_CHUNK].contiguous(),
                       qc[..., s:s + SIZE_PLAIN_CHUNK].contiguous(), *a)
                 for s in range(0, m.shape[-1], SIZE_PLAIN_CHUNK)]
        return tuple(torch.cat(p, dim=-1) for p in zip(*parts))

    out = {"B": SIZE_K4_B, "launches_by": launches,
           "vs_plain": compare_solve(kernel, plain_chunks,
                                     tuple(t.double() for t in qps32), args,
                                     1, "K4 nv6_k1")}
    def count(qps):
        # On the first COUNT_B QPs, scaled to the batch, as the other K4
        # bounds are counted.
        n = qps[0].shape[-1]
        first = tuple(t[..., :COUNT_B].contiguous() for t in qps)
        needed = host_for(model).cold_solve_count(
            *first, *args, exits=k4_exits(first[0].dtype),
            threads=os.cpu_count() or 1)["needed"]
        return {"needed": needed * n / first[0].shape[-1]}

    out.update(solve_timing(kernel, plain, qps32, args, 1, plain_b=B,
                            count=count))
    for key, t in (("ptxas", "f32"), ("ptxas_float64", "f64")):
        out[key] = ptxas_lines(f"cold_hybrid_solve_nv6_k1_{t}")
    return out


def three_cubes_readings() -> dict:
    """The three cubes on the K6 route: THREE_CUBES_STEPS vmapped training
    steps at THREE_CUBES_B transitions (one K6 launch at k = 15 a step),
    K6 on the THREE_CUBES_B problems the step hands it and on
    THREE_CUBES_CHECK_B random ones against its plain version (float64
    within TOL64 with equal masks, float32 by the tail rule), its times
    and bound, ptxas's lines."""
    import torch
    from dair_pll_tpu_torch.ops import cone_kernels
    system = three_cubes_system()
    model = system.model
    if model.n_contacts != 15:
        raise AssertionError(f"three cubes: {model.n_contacts} contacts")
    x, x_plus = three_cube_transitions(system, THREE_CUBES_B)
    seconds, losses, launches = vmapped_steps(
        system, x, x_plus, THREE_CUBES_STEPS, use_apgd_kernel=True)
    expected = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                "K6": THREE_CUBES_STEPS}
    if launches != expected:
        raise AssertionError(f"three cubes: launches {launches}, expected "
                             f"{expected}")
    by = dict(cone_kernels.solve_cone_qp_cuda.launches_by)
    Q32, q32 = apgd_loss_qps(system, system.initial_params(torch.float32), x,
                             x_plus)
    main, failures = compare_k6(Q32.double(), q32.double(),
                                chunk=THREE_CUBES_CHECK_B)
    rand, more = compare_k6(*random_psd_qps(THREE_CUBES_CHECK_B, 15,
                                            system.device))
    failures += more
    small = (Q32[:B].contiguous(), q32[:B].contiguous())
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: cone_kernels.plain_apgd(
            *small, APGD_ITERATIONS), reps=2, warmup=1)
        ops_per_problem = apgd_operations(*small) / B
    timing = apgd_timing(Q32, q32, ops_per_problem)
    out = {"B": THREE_CUBES_B, "k": 15, "steps": THREE_CUBES_STEPS,
           "step_median_ms": statistics.median(seconds) * 1e3,
           "steps_per_s": len(seconds) / sum(seconds),
           "transitions_per_s": THREE_CUBES_B * len(seconds) / sum(seconds),
           "losses": losses, "launches": launches, "launches_by": by,
           "K6_vs_plain": main, "K6_vs_plain_random": rand,
           **timing, "plain_ms": plain_ms, "plain_B": B,
           "operations_per_problem": ops_per_problem,
           "ptxas": ptxas_lines("apgd_cone_solve_k15_f32"),
           "ptxas_float64": ptxas_lines("apgd_cone_solve_k15_f64")}
    if failures:
        emit({"phase": "size_cover_three_cubes", **out})
        raise AssertionError("three cubes: " + "; ".join(failures))
    return out


def phase_size_cover() -> dict:
    """Every size of the JAX kernels' cover on the card (phase 14): the
    ball and the box and sphere body (generic K1-K3 built at first use,
    trained at SIZE_TRAIN_B; K5 at (6, 1) and (6, 5) in their rollouts;
    K4 at (6, 1) on the ball's cold loss), the wide polygon's loss
    kernels against plain (``wide_polygon_readings``) and the three cubes
    on the K6 route at k = 15. One JSON line each:
    ``size_cover_<model>``."""
    import torch
    from dair_pll_tpu_torch.ops import soa_kernels
    start_host_builds()
    new_sizes = ("nv6_k1", "nv6_k5", "_k15_", "b1_q7_v6_k1_w1",
                 "b1_q7_v6_k5_w4_1")  # and the wide polygon's _n20
    emit({"phase": "size_cover_builds", "instances": {
        name: {"seconds": reading["seconds"],
               "ptxas": ptxas_of(reading["log"])}
        for name, reading in soa_kernels.build_readings().items()
        if any(key in name for key in new_sizes)}})
    out = {}
    for seed, (name, system) in enumerate(size_systems().items()):
        t0 = time.perf_counter()
        out[name] = size_model_readings(name, system, 20 + seed)
        if name == "ball":
            out["ball"]["K4"] = ball_cold_solve(system)
        out[name]["seconds"] = time.perf_counter() - t0
        emit({"phase": f"size_cover_{name}", **out[name]})
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["wide_polygon"] = wide_polygon_readings()
    out["wide_polygon"]["seconds"] = time.perf_counter() - t0
    emit({"phase": "size_cover_wide_polygon", **out["wide_polygon"]})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["three_cubes"] = three_cubes_readings()
    out["three_cubes"]["seconds"] = time.perf_counter() - t0
    emit({"phase": "size_cover_three_cubes", **out["three_cubes"]})
    torch.cuda.empty_cache()
    return out


# -- the experiment layer (phase 12) ---------------------------------------------

#: The experiment layer's phases: the CLI's own recipe (256 tosses of 80
#: states, batch 256), the production batch (8,192 tosses, batch 16,384),
#: and the card held against the CPU on 32 tosses of 20 states.
EXPERIMENT_EPOCHS = 5
#: States a toss of ``experiment``: 40 since PR 14, half the CLI's 80, so
#: that the script keeps to its time limit: its data and its final
#: evaluation step the vmapped integrator, whose host-bound steps take the
#: same time at any batch (``PERF.md`` §4, §5).
EXPERIMENT_STATES = 40
#: Per-epoch evaluations (the CLI's default is every epoch of 5 train and
#: 5 valid tosses): ``experiment`` runs none, only the final one, as each
#: of 10 tosses on the vmapped integrator costs 17.6-28.8 s on an H100
#: (``PERF.md`` §5); ``experiment_scale`` evaluates every 5 epochs
#: 1,024 train and 1,024 valid tosses, which take the fused rollout (K5).
SCALE_EVAL_PERIOD = 5
SCALE_EVAL_SAMPLES = 1024
#: ``experiment_mesh_elbow``: 1,024 tosses (the fused rollout on K5 for
#: generation and the final evaluation), batch 2,048 (the fused loss for
#: the no-gradient passes: K4 for the ICNN cube, the generic K1 for the
#: elbow), no per-epoch evaluation.
MESH_ELBOW_TOSSES = 1024
MESH_ELBOW_BATCH = 2048
SCALE_TOSSES = 8192
SCALE_BATCH = 16384
SCALE_EPOCHS = 10
SCALE_TRACED_EPOCH = 8
MESH_ELBOW_EPOCHS = 2
#: States an elbow toss of ``experiment_mesh_elbow``: 60 since PR 14, half
#: the CLI's 120, made with the CLI's generator before its call (which
#: then generates none), so that the script keeps to its time limit: the
#: fused rollouts of its data and its final evaluation take most of the
#: phase (``PERF.md`` §4).
ELBOW_TOSS_STATES = 60
CARD_CPU_TOSSES = 32
CARD_CPU_LENGTH = 20
CARD_CPU_LOSS_RTOL = 1e-8
CARD_CPU_PARAM_RTOL = 1e-5
CARD_CPU_PARAM_ATOL = 1e-9
CARD_CPU_MEAN_RTOL = 1e-6
#: The box cube's true mass, side length and friction (the URDF's).
CUBE_TRUTH = {"m": 0.37, "len": 0.1048, "mu": 0.15}
EXPERIMENT_KERNELS = ("K1", "K2", "K3", "K4", "K5")


def experiment_launches() -> dict:
    launches = read_launches()
    return {name: launches[name] for name in EXPERIMENT_KERNELS}


def eval_k5(n_trajectories: int, n_slices: int, horizon: int) -> int:
    """K5 launches of one system's evaluation: the rollouts take the fused
    path from FUSED_ROLLOUT_MIN_BATCH trajectories (a launch a step), the
    one-step slice losses from chunks of that many slices (a launch a
    chunk)."""
    from dair_pll_tpu_torch.multibody.learnable_system import (
        FUSED_ROLLOUT_MIN_BATCH)
    from dair_pll_tpu_torch.training.experiment import (
        EVALUATION_SLICE_CHUNK)
    chunk = min(EVALUATION_SLICE_CHUNK,
                1 << max(0, n_slices - 1).bit_length())
    chunks = -(-n_slices // chunk)
    return ((horizon if n_trajectories >= FUSED_ROLLOUT_MIN_BATCH else 0) +
            (chunks if chunk >= FUSED_ROLLOUT_MIN_BATCH else 0))


class LaunchesAround:
    """Counts the kernels' launches inside calls of a method (the
    dataset generator's ``generate``), patched for the ``with`` block;
    the counters restart from 0 after each call, so that the next
    reading counts what follows."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name
        self.launches = {name: 0 for name in EXPERIMENT_KERNELS}
        self.seconds = 0.0

    def __enter__(self):
        original = self.original = getattr(self.owner, self.name)

        def counted(*args, **kwargs):
            before = experiment_launches()
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            self.seconds += time.perf_counter() - t0
            after = experiment_launches()
            for key in self.launches:
                self.launches[key] += after[key] - before[key]
            reset_launches()
            return out

        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.original)


def cli_run():
    """The CLI's ``run`` with videos off (the card's machine has no
    matplotlib)."""
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    return functools.partial(cli.run, video_period=0)


def run_experiment(label: str, storage: str, run_fn=None,
                   traced_epoch=None, **options) -> dict:
    """An experiment's ``run`` on the card with the given options: the
    CLI's (``cli_run``) or an example's (``run_fn``), reading per epoch
    the train loss, the best valid loss, finite parameters, the kernels'
    launches (training, the no-gradient loss passes and that epoch's
    evaluation) and, from the run's log, the seconds of training,
    evaluation and logging; then the last reported epoch's parameters and
    the final evaluation's launches."""
    import torch
    from dair_pll_tpu_torch.data import generation
    run_fn = run_fn or cli_run()
    epochs, trace, last = [], {}, {}

    def callback(epoch, params, train_loss, best_valid):
        torch.cuda.synchronize()
        epochs.append({"epoch": epoch, "train_loss": train_loss,
                       "best_valid": best_valid,
                       "launches": experiment_launches(),
                       "finite": all(bool(torch.isfinite(leaf).all())
                                     for leaf in params.parameters())})
        last["params"] = [leaf.detach().cpu().clone()
                          for leaf in params.parameters()]
        reset_launches()
        if traced_epoch is not None and epoch == traced_epoch - 1:
            trace["profiler"] = start_trace()
            trace["t0"] = time.perf_counter()
        elif "profiler" in trace and "result" not in trace:
            trace["result"] = stop_trace(trace["profiler"],
                                         time.perf_counter() - trace["t0"])

    reset_launches()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with LaunchesAround(generation.ExperimentDatasetGenerator,
                        "generate") as gen, \
            contextlib.redirect_stdout(printed):
        out = run_fn(storage=storage, epoch_callback=callback, **options)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if "generated" in out and f"generated {out['generated']} " \
            "trajectories" not in printed.getvalue():
        raise AssertionError(f"{label}: the run printed "
                             f"{printed.getvalue()[:400]!r}")
    final_launches = experiment_launches()
    experiment = out["experiment"]
    config = experiment.config
    log_path = os.path.join(storage, "runs", config.run_name, "log.jsonl")
    with open(log_path, encoding="utf-8") as handle:
        log = {r["epoch"]: r for r in map(json.loads, handle)
               if r["epoch"] >= 0}
    train_set, valid_set, test_set = \
        experiment.data_manager.get_trajectory_sets()
    for entry in epochs:
        record = log[entry["epoch"]]
        entry.update({key: record[key] for key in (
            "training_duration", "evaluation_duration",
            "logging_duration")})
        if entry["epoch"] > 0:
            entry["train_slices_per_second"] = (
                train_set.n_slices / record["training_duration"])
    return {"label": label, "out": out, "epochs": epochs, "log": log,
            "last_params": last.get("params"),
            "seconds": seconds, "generation": {
                "generated": out.get("generated"), "seconds": gen.seconds,
                "launches": gen.launches},
            "final_launches": final_launches,
            "sets": (train_set, valid_set, test_set),
            "trace": trace.get("result")}


def start_trace():
    from torch.profiler import ProfilerActivity, profile
    profiler = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    profiler.__enter__()
    return profiler


def stop_trace(profiler, window_seconds: float) -> dict:
    """Device busy share, kernels and the top kernels by device time of a
    traced window."""
    import collections
    import torch
    torch.cuda.synchronize()
    profiler.__exit__(None, None, None)
    per_name = collections.Counter()
    kernels = 0
    for event in profiler.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            per_name[event.name] += event.time_range.elapsed_us()
            kernels += 1
    device_ms = sum(per_name.values()) / 1e3
    by_kind = collections.Counter()
    for name, us in per_name.items():
        by_kind[kernel_kind(name)] += us / 1e3
    return {"window_ms": window_seconds * 1e3, "device_ms": device_ms,
            "device_kernels": kernels,
            "device_busy_share": device_ms / (window_seconds * 1e3),
            "device_ms_by_kind": by_kind,
            "top_kernels_ms": [[name[:80], us / 1e3]
                               for name, us in per_name.most_common(8)]}


def expected_experiment_launches(run: dict, force_fused: bool,
                                 warm_kernels: bool, icnn: bool) -> list:
    """Per epoch, the launches the run's steps and passes need: K3 and K2
    once a training step (the ICNN cube's warm loss runs K5 instead), K1
    once a no-gradient loss batch on the fused path (from
    FUSED_LOSS_MIN_BATCH slices a batch, or forced; the ICNN cube's cold
    loss runs K4 instead), K5 by ``eval_k5`` for each evaluation."""
    from dair_pll_tpu_torch.multibody.learnable_system import (
        FUSED_LOSS_MIN_BATCH)
    experiment = run["out"]["experiment"]
    config = experiment.config
    batch = int(config.optimizer_config.batch_size.value)
    train_set, valid_set, _ = run["sets"]
    steps = -(-train_set.n_slices // batch)
    valid_batches = -(-valid_set.n_slices // batch)
    fused_passes = force_fused or batch >= FUSED_LOSS_MIN_BATCH
    period = max(1, config.full_evaluation_period)
    last = config.optimizer_config.epochs
    expected = []
    for entry in run["epochs"]:
        epoch = entry["epoch"]
        passes = valid_batches + (steps if epoch == 0 else 0)
        trained = steps if epoch > 0 else 0
        fused = passes if fused_passes else 0
        launches = {"K1": 0 if icnn else fused,
                    "K3": trained if warm_kernels and not icnn else 0,
                    "K2": trained if warm_kernels and not icnn else 0,
                    "K4": fused if icnn else 0,
                    "K5": trained if icnn else 0}
        if config.full_evaluation_samples > 0 and (
                epoch % period == 0 or epoch == last):
            n = config.full_evaluation_samples
            sampled = [experiment.data_manager.make_sampled_set(s, n)
                       for s in (train_set, valid_set)]
            trajectories = sum(len(s.trajectories) for s in sampled)
            slices = sum(s.n_slices for s in sampled)
            horizon = sampled[0].trajectories[0].shape[0] - 1
            launches["K5"] += eval_k5(trajectories, slices, horizon)
        expected.append(launches)
    return expected


def final_expected_k5(run: dict) -> int:
    """K5 launches of the final evaluation: oracle and model over all
    sets together."""
    sets = run["sets"]
    trajectories = sum(len(s.trajectories) for s in sets)
    slices = sum(s.n_slices for s in sets)
    horizon = sets[0].trajectories[0].shape[0] - 1
    return 2 * eval_k5(trajectories, slices, horizon)


def learned_physics(experiment, params) -> dict:
    """The learned cube's mass, side lengths and friction, from the
    system's logging summary."""
    scalars = experiment.learned_system.summary(params, {}).scalars
    return {"m": scalars["cube::body_m"],
            "len": [scalars[f"cube::body_len_{a}"] for a in "xyz"],
            "mu": scalars["cube::body_mu"]}


def wrong_init(scratch: str, name: str) -> str:
    """The path of the cube's or elbow's wrong-init URDF
    (``assets.wrong_init_urdf``), written into ``scratch``."""
    from dair_pll_tpu_torch import assets
    path = os.path.join(scratch, f"{name}_wrong_init.urdf")
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(assets.wrong_init_urdf(name))
    return path


def epoch_table(run: dict) -> list:
    """The run's per-epoch readings for a report."""
    return [{key: entry[key] for key in (
        "epoch", "train_loss", "best_valid", "training_duration",
        "evaluation_duration", "logging_duration", "launches",
        "train_slices_per_second") if key in entry}
        for entry in run["epochs"]]


def check_falling(run: dict) -> None:
    """The last epoch's train loss below epoch 0's; every epoch's
    parameters finite."""
    epochs = run["epochs"]
    if not epochs[-1]["train_loss"] < epochs[0]["train_loss"]:
        raise AssertionError(f"{run['label']}: train loss "
                             f"{epochs[-1]['train_loss']} not below epoch "
                             f"0's {epochs[0]['train_loss']}")
    if not all(entry["finite"] for entry in epochs):
        raise AssertionError(f"{run['label']}: non-finite parameters")


def check_experiment(run: dict, expected: list, generation_k5: int,
                     final_k5, cube_physics: bool) -> dict:
    """The checks of an experiment phase; returns its report."""
    import torch
    out = run["out"]
    epochs = run["epochs"]
    got = [entry["launches"] for entry in epochs]
    if got != expected:
        raise AssertionError(f"{run['label']}: launches {got}, expected "
                             f"{expected}")
    if run["generation"]["launches"]["K5"] != generation_k5:
        raise AssertionError(f"{run['label']}: generation launched K5 "
                             f"{run['generation']['launches']['K5']} times, "
                             f"expected {generation_k5}")
    if final_k5 is not None and run["final_launches"]["K5"] != final_k5:
        raise AssertionError(f"{run['label']}: final evaluation launched "
                             f"K5 {run['final_launches']['K5']} times, "
                             f"expected {final_k5}")
    check_falling(run)
    if not all(bool(torch.isfinite(leaf).all())
               for leaf in out["best_params"].parameters()):
        raise AssertionError(f"{run['label']}: non-finite parameters")
    config = out["experiment"].config
    run_dir = os.path.join(config.storage, "runs", config.run_name)
    if not os.path.exists(os.path.join(run_dir, "checkpoint.npz")):
        raise AssertionError(f"{run['label']}: no checkpoint")
    urdfs = out["urdfs"]
    if not urdfs or not all(os.path.exists(p) for p in urdfs.values()):
        raise AssertionError(f"{run['label']}: no re-exported URDF")
    means = {key: value for key, value in out["statistics"].items()
             if key.endswith("_mean")}
    report = {
        "generated": run["generation"]["generated"],
        "generation_seconds": run["generation"]["seconds"],
        "generation_launches": run["generation"]["launches"],
        "train_slices": run["sets"][0].n_slices,
        "valid_slices": run["sets"][1].n_slices,
        "epochs": epoch_table(run),
        "final_evaluation_launches": run["final_launches"],
        "means": means, "seconds": run["seconds"],
        "urdfs": {name: os.path.basename(path)
                  for name, path in urdfs.items()}}
    if cube_physics:
        report["learned"] = learned_physics(out["experiment"],
                                            out["best_params"])
        report["truth"] = CUBE_TRUTH
    if run["trace"] is not None:
        report["traced_epoch"] = run["trace"]
    return report


def rerun_resumes(label: str, storage: str, run_fn=None,
                  **options) -> dict:
    """A second call of the same run (``run_experiment``'s) must resume
    from the finished checkpoint, no epoch running again, and generate
    nothing."""
    epochs = []
    buffer = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buffer):
        out = (run_fn or cli_run())(
            storage=storage, epoch_callback=lambda e, *a: epochs.append(e),
            **options)
    seconds = time.perf_counter() - t0
    text = buffer.getvalue()
    if epochs or ("generated" in out and
                  "generated 0 trajectories" not in text):
        raise AssertionError(f"{label}: the rerun did not resume: "
                             f"{text[:400]!r}, epochs {epochs}")
    return {"rerun_seconds": seconds, "rerun_generated": out.get("generated"),
            "rerun_launches": experiment_launches()}


class EpochRecorder:
    """Records every training epoch's batch table and step losses: the
    experiment's method ``method`` that makes the epoch function
    (``"_build_train_epoch"``, or ``"_build_warm_train_epoch"``, whose
    ``seed`` keyword goes into each record) patched for the ``with``
    block."""

    def __init__(self, method: str):
        self.method = method
        self.records = []

    def __enter__(self):
        from dair_pll_tpu_torch.training import experiment as texperiment
        self.cls = texperiment.SupervisedLearningExperiment
        self.original = original = getattr(self.cls, self.method)
        records = self.records

        def recording(experiment, *args, **kwargs):
            built = original(experiment, *args, **kwargs)
            epoch_fn = built[0] if isinstance(built, tuple) else built

            def recorded(*epoch_args):
                losses = epoch_fn(*epoch_args)
                records.append({
                    **kwargs, "batches": epoch_args[-1].cpu().numpy(),
                    "losses": losses.detach().cpu().double().numpy()})
                return losses
            return (recorded, *built[1:]) if isinstance(built, tuple) \
                else recorded

        setattr(self.cls, self.method, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.original)


def param_err_over_bar(a, b) -> float:
    """The largest ``|a - b| / (atol + rtol |b|)`` over the leaves, at
    CARD_CPU_PARAM_ATOL and CARD_CPU_PARAM_RTOL: at most 1 passes."""
    import numpy as np
    worst = 0.0
    for leaf_a, leaf_b in zip(a, b):
        leaf_b = np.asarray(leaf_b, np.float64)
        worst = max(worst, float(np.max(
            np.abs(np.asarray(leaf_a, np.float64) - leaf_b) /
            (CARD_CPU_PARAM_ATOL + CARD_CPU_PARAM_RTOL * np.abs(leaf_b)))))
    return worst


#: The card's run of ``experiment_card_vs_cpu``, the unsharded reference
#: of ``sharded_experiment``.
_FLOAT64_REFERENCE = {}


def float64_run(storage: str, device: str, run_name: str = "card_vs_cpu",
                **options) -> dict:
    """The float64 recipe of ``experiment_card_vs_cpu`` (the CLI's
    ``run``: a seed and a warm epoch at batch 256 on CARD_CPU_TOSSES tosses
    already in ``storage``, float64 parameters, ``loss_dtype="float64"``
    and ``force_fused_loss``, the final evaluation) on ``device``, with
    more ``options`` (the sharding flags): the parameters after each
    epoch, each epoch's batch table and step losses, the launches and the
    run's output."""
    import torch
    # float64 parameters: with the float32 default, Adam's float32 update
    # and the float32 rounding of the float64 gradients part the two
    # devices by an ulp from the second step on (on an H100 the step
    # losses came 6.4e-8 apart, PERF.md §6), and the float32 evaluation's
    # one-step losses sit at rounding level (the means up to 4.4x apart).
    # No per-epoch evaluation: the final one gives the statistics.
    params_by_epoch = []
    reset_launches()
    with EpochRecorder("_build_warm_train_epoch") as recorder, \
            contextlib.redirect_stdout(io.StringIO()):
        out = cli_run()(
            storage=storage, device=device, n_pop=CARD_CPU_TOSSES,
            epochs=2, force_fused_loss=True, use_warm_loss=True,
            loss_dtype="float64", dtype=torch.float64, eval_samples=0,
            run_name=run_name,
            epoch_callback=lambda e, p, *a: params_by_epoch.append(
                [leaf.detach().cpu().numpy().copy()
                 for leaf in p.parameters()]),
            **options)
    return {"out": out, "params": params_by_epoch,
            "records": recorder.records, "launches": experiment_launches()}


def phase_experiment_card_vs_cpu(scratch: str) -> dict:
    """One seed and one warm epoch of the box cube on the card (K1, K3, K2
    in float64: float64 parameters, ``loss_dtype="float64"``,
    ``force_fused_loss``) and the same two epochs on the CPU, on copies of
    one storage of 32 tosses of 20 states generated on the CPU: each
    step's loss, the parameters after each epoch, the batch tables and the
    final ``_mean`` statistics."""
    import shutil
    import numpy as np
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    t0 = time.perf_counter()
    card_dir = os.path.join(scratch, "card_vs_cpu_card")
    cpu_dir = os.path.join(scratch, "card_vs_cpu_cpu")
    cli.generate_tosses("cube", card_dir, CARD_CPU_TOSSES, CARD_CPU_LENGTH,
                        device="cpu")
    shutil.copytree(card_dir, cpu_dir)
    runs = {device: float64_run(storage, device)
            for device, storage in (("cuda", card_dir), ("cpu", cpu_dir))}
    _FLOAT64_REFERENCE["card"] = runs["cuda"]
    card, cpu = runs["cuda"]["records"], runs["cpu"]["records"]
    if [r["seed"] for r in card] != [True, False] or \
            [r["seed"] for r in cpu] != [True, False]:
        raise AssertionError(f"epochs: card {[r['seed'] for r in card]}, "
                             f"cpu {[r['seed'] for r in cpu]}")
    for a, b in zip(card, cpu):
        if not np.array_equal(a["batches"], b["batches"]):
            raise AssertionError("the card's and the CPU's batch tables "
                                 "differ")
    loss_rel = [float(np.max(np.abs(a["losses"] - b["losses"]) /
                             np.abs(b["losses"]))) for a, b in zip(card, cpu)]
    param_err = [param_err_over_bar(a, b) for a, b in
                 zip(runs["cuda"]["params"], runs["cpu"]["params"])]
    stats = {d: runs[d]["out"]["statistics"] for d in runs}
    mean_rel = {}
    for key, want in stats["cpu"].items():
        if key.endswith("_mean"):
            got = stats["cuda"][key]
            mean_rel[key] = abs(got - want) / max(abs(want), 1e-300)
    train_set = runs["cuda"]["out"]["experiment"].data_manager \
        .get_trajectory_sets()[0]
    batch = 256
    steps = -(-train_set.n_slices // batch)
    valid_set = runs["cuda"]["out"]["experiment"].data_manager \
        .get_trajectory_sets()[1]
    k1 = steps + 3 * (-(-valid_set.n_slices // batch))
    step_errors = [(np.abs(a["losses"] - b["losses"]) /
                    np.abs(b["losses"])).tolist() for a, b in zip(card, cpu)]
    launches = runs["cuda"]["launches"]
    report = {"phase": "experiment_card_vs_cpu",
              "tosses": CARD_CPU_TOSSES, "states": CARD_CPU_LENGTH,
              "steps_per_epoch": steps,
              "max_step_loss_rel_err": loss_rel,
              "step_loss_rel_err": step_errors,
              "param_err_over_bar_per_epoch": param_err,
              "max_mean_rel_err": max(mean_rel.values()),
              "worst_means": sorted(mean_rel.items(),
                                    key=lambda kv: -kv[1])[:4],
              "launches": launches,
              "expected_launches": {"K1": k1, "K3": 2 * steps,
                                    "K2": 2 * steps},
              "seconds": time.perf_counter() - t0}
    emit(report)
    failures = []
    if max(loss_rel) > CARD_CPU_LOSS_RTOL:
        failures.append(f"step losses differ by {max(loss_rel)}")
    if max(param_err) > 1.0:
        failures.append(f"parameters over the bar by {max(param_err)}")
    if max(mean_rel.values()) > CARD_CPU_MEAN_RTOL:
        failures.append(f"_mean statistics differ by "
                        f"{max(mean_rel.values())}")
    for name, want in report["expected_launches"].items():
        if launches[name] != want:
            failures.append(f"{name} launched {launches[name]} times, "
                            f"expected {want}")
    if failures:
        raise AssertionError("experiment_card_vs_cpu: " +
                             "; ".join(failures))
    return report


def phase_experiment(scratch: str) -> dict:
    """The CLI's own recipe on the card: the box cube, 256 tosses of
    EXPERIMENT_STATES states (made first with the CLI's generator, so that
    its call generates none), batch 256, lr 1e-3, 5 epochs, the final
    evaluation only, from the wrong init; then the same call again, which
    must resume."""
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    storage = os.path.join(scratch, "experiment")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.generate_tosses("cube", storage, cli.N_POP, EXPERIMENT_STATES)
    made_seconds = time.perf_counter() - t0
    options = dict(epochs=EXPERIMENT_EPOCHS, eval_samples=0,
                   initial_urdf=wrong_init(scratch, "cube"))
    run = run_experiment("experiment", storage, **options)
    report = check_experiment(
        run, expected_experiment_launches(run, False, True, False),
        generation_k5=0, final_k5=final_expected_k5(run),
        cube_physics=True)
    report.update(rerun_resumes("experiment", storage, **options))
    report["states"] = EXPERIMENT_STATES
    report["made_seconds"] = made_seconds
    emit({"phase": "experiment", **report})
    return report


def phase_experiment_scale(scratch: str) -> dict:
    """The production batch: 8,192 tosses (the simulation bench's count,
    fused rollouts on K5), batch 16,384, 10 epochs (a warm reseed at
    epoch 9), evaluations of SCALE_EVAL_SAMPLES train and valid tosses
    every SCALE_EVAL_PERIOD epochs (the monitored valid loss), the final
    evaluation; one warm epoch traced."""
    storage = os.path.join(scratch, "experiment_scale")
    options = dict(epochs=SCALE_EPOCHS, n_pop=SCALE_TOSSES,
                   batch_size=SCALE_BATCH, generation_batch=SCALE_TOSSES,
                   eval_period=SCALE_EVAL_PERIOD,
                   eval_samples=SCALE_EVAL_SAMPLES,
                   initial_urdf=wrong_init(scratch, "cube"))
    run = run_experiment("experiment_scale", storage,
                         traced_epoch=SCALE_TRACED_EPOCH, **options)
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    report = check_experiment(
        run, expected_experiment_launches(run, False, True, False),
        generation_k5=cli.TRAJECTORY_LENGTHS["cube"] - 1,
        final_k5=final_expected_k5(run), cube_physics=True)
    steps = -(-run["sets"][0].n_slices // SCALE_BATCH)
    if run["trace"] is not None:
        report["traced_epoch"]["steps"] = steps
        report["traced_epoch"]["epoch"] = SCALE_TRACED_EPOCH
        report["traced_epoch"]["device_kernels_per_step"] = (
            run["trace"]["device_kernels"] / steps)
    report.update(rerun_resumes("experiment_scale", storage, **options))
    emit({"phase": "experiment_scale", **report})
    return report


def phase_experiment_mesh_elbow(scratch: str) -> dict:
    """The CLI with ``--mesh`` (the ICNN cube: its warm loss on K5, its
    cold no-gradient passes on K4, a mesh in the summary, the learned mesh
    in the exported URDF) and with ``--system elbow`` (the generic K3/K2
    and K1, from its wrong init, K5 at (7, 8) in its rollouts), 2 epochs
    each, 1,024 tosses at batch 2,048."""
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    reports = {}
    for label, options, icnn in (
            ("mesh", dict(box=False), True),
            ("elbow", dict(system="elbow",
                           initial_urdf=wrong_init(scratch, "elbow")),
             False)):
        storage = os.path.join(scratch, f"experiment_{label}")
        options = dict(options, epochs=MESH_ELBOW_EPOCHS,
                       n_pop=MESH_ELBOW_TOSSES, batch_size=MESH_ELBOW_BATCH,
                       generation_batch=MESH_ELBOW_TOSSES, eval_samples=0)
        system = options.get("system", "cube")
        made = 0
        if system == "elbow":
            # The elbow's tosses are made first, at ELBOW_TOSS_STATES.
            with contextlib.redirect_stdout(io.StringIO()):
                made = cli.generate_tosses(
                    "elbow", storage, MESH_ELBOW_TOSSES, ELBOW_TOSS_STATES,
                    generation_batch=MESH_ELBOW_TOSSES)
        run = run_experiment(f"experiment_{label}", storage, **options)
        report = check_experiment(
            run, expected_experiment_launches(run, False, True, icnn),
            generation_k5=0 if made else cli.TRAJECTORY_LENGTHS[system] - 1,
            final_k5=final_expected_k5(run), cube_physics=False)
        report["made_first"] = made
        config = run["out"]["experiment"].config
        run_dir = os.path.join(config.storage, "runs", config.run_name)
        if icnn:
            meshes = os.listdir(os.path.join(run_dir, "meshes"))
            with open(next(iter(run["out"]["urdfs"].values())),
                      encoding="utf-8") as handle:
                urdf = handle.read()
            if not meshes or ".obj" not in urdf:
                raise AssertionError(f"mesh: summary meshes {meshes}, "
                                     "URDF without the learned mesh")
            report["summary_meshes"] = sorted(meshes)
        report.update(rerun_resumes(f"experiment_{label}", storage,
                                    **options))
        reports[label] = report
    emit({"phase": "experiment_mesh_elbow", **reports})
    return reports


def experiment_launch_summary(report: dict, kernel: str) -> dict:
    """One kernel's launches in an experiment phase: by the dataset's
    generation, per epoch (training, loss passes, that epoch's
    evaluation) and by the final evaluation."""
    return {"generation": report["generation_launches"][kernel],
            "per_epoch": [entry["launches"][kernel]
                          for entry in report["epochs"]],
            "final_evaluation": report["final_evaluation_launches"][kernel]}


def run_experiment_phases(run) -> dict:
    """Phase 12's four phases, in their order, in a fresh directory of the
    checkout."""
    import shutil
    scratch = os.path.join(HERE, "build", "experiment_smoke")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    run("experiment_card_vs_cpu", phase_experiment_card_vs_cpu, scratch)
    reports = {"experiment": run("experiment", phase_experiment, scratch)}
    reports.update(run("experiment_mesh_elbow", phase_experiment_mesh_elbow,
                       scratch))
    reports["experiment_scale"] = run("experiment_scale",
                                      phase_experiment_scale, scratch)
    return reports


# -- the sharded experiment (phase 14) -------------------------------------------

#: ``sharded_experiment``: the JAX package's bars for sharded against
#: unsharded training (``tests/test_parallel.py:219-224``): losses rtol
#: 1e-4, parameters rtol 1e-6 and atol 1e-10; the production recipe's
#: epochs, and the tosses a rank's evaluation pass rolls out.
SHARD_LOSS_RTOL = 1e-4
SHARD_PARAM_RTOL = 1e-6
SHARD_PARAM_ATOL = 1e-10
SHARDED_EPOCHS = 2
SHARDED_EVAL_TOSSES = 2048
#: Seconds a worker process may take before it is killed.
WORKER_TIMEOUT = 300


def free_port() -> int:
    """A free TCP port of this machine."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_worker(spec_path: str) -> int:
    """One rank of ``sharded_experiment`` (``chip_smoke.py
    --sharded-worker SPEC``): joins the process group the spec names
    (``parallel/multiprocess.initialize``, on card 0), runs its recipe with
    ``shard_training`` and ``shard_evaluation``, and writes its readings
    to the spec's ``out`` (JSON)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from dair_pll_tpu_torch.parallel import multiprocess
    with open(spec_path, encoding="utf-8") as handle:
        spec = json.load(handle)
    device = multiprocess.initialize(
        f"127.0.0.1:{spec['port']}", spec["world"], spec["rank"], [0],
        spec["backend"], timeout_s=WORKER_TIMEOUT)
    out = {"rank": spec["rank"], "world": spec["world"],
           "backend": spec["backend"]}
    flags = dict(shard_training=True, shard_evaluation=True)
    if spec["kind"] == "float64":
        run = float64_run(spec["storage"], str(device),
                          run_name=spec["run_name"], **flags)
        out.update(
            params=[[leaf.tolist() for leaf in epoch]
                    for epoch in run["params"]],
            losses=[r["losses"].tolist() for r in run["records"]],
            batches=[r["batches"].tolist() for r in run["records"]],
            launches=run["launches"],
            means={key: value for key, value in
                   run["out"]["statistics"].items()
                   if key.endswith("_mean")})
    else:
        from dair_pll_tpu_torch.examples import contactnets_simple as cli
        experiment = cli.build_experiment(
            storage=spec["storage"], run_name=spec["run_name"],
            epochs=SHARDED_EPOCHS, eval_samples=0, batch_size=SCALE_BATCH,
            device=str(device), initial_urdf=spec["initial_urdf"], **flags)
        epochs, marks = [], {"t": None}

        def callback(epoch, params, train_loss, best_valid):
            torch.cuda.synchronize()
            now = time.perf_counter()
            epochs.append({"epoch": epoch, "train_loss": train_loss,
                           "seconds": (None if marks["t"] is None
                                       else now - marks["t"]),
                           "launches": read_launches_by()})
            reset_launches()
            marks["t"] = time.perf_counter()

        reset_launches()
        _, _, params = experiment.train(callback)
        train_set = experiment.data_manager.get_trajectory_sets()[0]
        sampled = experiment.data_manager.make_sampled_set(
            train_set, SHARDED_EVAL_TOSSES)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        stats = experiment.evaluate_systems_on_sets(
            {"model": (experiment.learned_system, params)},
            {"train": sampled})
        torch.cuda.synchronize()
        out.update(epochs=epochs, train_slices=train_set.n_slices,
                   evaluation={"tosses": len(sampled.trajectories),
                               "seconds": time.perf_counter() - t0,
                               "launches": read_launches_by(),
                               "loss_mean": float(np.mean(
                                   stats["train_model_loss"]))},
                   params=[leaf.detach().cpu().double().flatten().tolist()
                           for leaf in params.parameters()])
    dist.barrier()
    dist.destroy_process_group()
    with open(spec["out"], "w", encoding="utf-8") as handle:
        json.dump(out, handle)
    return 0


def launch_workers(scratch: str, label: str, kind: str, world: int,
                   backend: str, storage: str, **extra) -> list:
    """Starts ``world`` processes of :func:`sharded_worker` (one process
    group on a free port); returns their ``(process, spec)``."""
    port = free_port()
    procs = []
    for rank in range(world):
        spec = {"port": port, "world": world, "rank": rank,
                "backend": backend, "kind": kind, "storage": storage,
                "run_name": f"{label}_{kind}",
                "out": os.path.join(scratch, f"{label}_{kind}_{rank}.json"),
                **extra}
        path = os.path.join(scratch, f"{label}_{kind}_{rank}.spec.json")
        with open(path, "w", encoding="utf-8") as handle:
            json.dump(spec, handle)
        log = open(path + ".log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--sharded-worker", path], stdout=log,
            stderr=subprocess.STDOUT, cwd=HERE), spec, log))
    return procs


def wait_workers(procs, timeout: float = WORKER_TIMEOUT) -> list:
    """Waits for the workers (each killed past ``timeout`` seconds);
    returns their readings; raises, with the end of each failed worker's
    log, if any failed."""
    deadline = time.perf_counter() + timeout
    failed = []
    for proc, spec, log in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        if proc.returncode != 0:
            with open(log.name, encoding="utf-8") as handle:
                failed.append(f"rank {spec['rank']} ({spec['backend']}, "
                              f"exit {proc.returncode}): "
                              f"{handle.read()[-3000:]}")
    if failed:
        raise AssertionError("sharded workers failed: " + " | ".join(failed))
    readings = []
    for _, spec, _ in procs:
        with open(spec["out"], encoding="utf-8") as handle:
            readings.append(json.load(handle))
    return readings


def sharded_float64_check(reference: dict, ranks: list) -> dict:
    """Rank 0's float64 run against the unsharded one: each step's loss
    (and so the final ``_mean`` statistics) within SHARD_LOSS_RTOL, the
    parameters after each epoch within SHARD_PARAM_RTOL and
    SHARD_PARAM_ATOL, the same batch tables, and every rank's parameters
    equal to rank 0's."""
    import numpy as np
    first = ranks[0]
    failures = []
    for a, b in zip(first["batches"], reference["records"]):
        if not np.array_equal(np.asarray(a), b["batches"]):
            failures.append("batch tables differ")
    loss_rel = max(float(np.max(np.abs(np.asarray(a) - b["losses"]) /
                                np.abs(b["losses"])))
                   for a, b in zip(first["losses"], reference["records"]))
    param_excess = max(
        float(np.max(np.abs(np.asarray(a) - b) -
                     (SHARD_PARAM_ATOL + SHARD_PARAM_RTOL * np.abs(b))))
        for epoch_a, epoch_b in zip(first["params"], reference["params"])
        for a, b in zip(epoch_a, epoch_b))
    want = {key: value for key, value in
            reference["out"]["statistics"].items() if key.endswith("_mean")}
    mean_rel = max(abs(first["means"][key] - value) /
                   max(abs(value), 1e-300) for key, value in want.items())
    same = all(rank["params"] == first["params"] for rank in ranks[1:])
    if loss_rel > SHARD_LOSS_RTOL:
        failures.append(f"step losses differ by {loss_rel:.3e}")
    if mean_rel > SHARD_LOSS_RTOL:
        failures.append(f"_mean statistics differ by {mean_rel:.3e}")
    if param_excess > 0:
        failures.append(f"parameters over the bar by {param_excess:.3e}")
    if not same:
        failures.append("the ranks' parameters differ")
    return {"max_step_loss_rel_err": loss_rel,
            "max_mean_rel_err": mean_rel,
            "param_excess_over_bar": param_excess,
            "ranks_equal": same,
            "launches_by_rank": [rank["launches"] for rank in ranks],
            "failures": failures}


def phase_sharded_experiment(scratch: str = None) -> dict:
    """``shard_training`` and ``shard_evaluation`` on the card (phase 14).
    The machine has one card: the two-process runs share it over gloo
    (CUDA tensors), the one-process runs take NCCL at world size 1 (which
    trains unsharded, as the JAX package does on one device). Checks: in
    float64 on CARD_CPU_TOSSES tosses, each run against the unsharded run
    of ``experiment_card_vs_cpu`` (the JAX package's bars); then the
    production recipe (SCALE_TOSSES tosses, batch SCALE_BATCH,
    SHARDED_EPOCHS epochs and an evaluation pass over SHARDED_EVAL_TOSSES
    train tosses): epoch seconds, slices/s and each rank's K1, K2, K3 and
    K5 launches, held to what the steps and rollouts need."""
    import shutil
    import torch
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    scratch = scratch or os.path.join(HERE, "build", "sharded_smoke")
    work = os.path.join(scratch, "sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    # The float64 check, on copies of one storage of 32 tosses.
    small = os.path.join(scratch, "card_vs_cpu_card")
    reference = _FLOAT64_REFERENCE.get("card")
    if reference is None:
        cli.generate_tosses("cube", small, CARD_CPU_TOSSES, CARD_CPU_LENGTH,
                            device="cpu")
        reference = float64_run(small, "cuda")
    runs = {}
    for label in ("gloo2", "nccl1"):
        storage = os.path.join(work, f"{label}_float64")
        shutil.copytree(os.path.join(small, "data"),
                        os.path.join(storage, "data"))
        runs[label] = launch_workers(
            work, label, "float64", 2 if label == "gloo2" else 1,
            "gloo" if label == "gloo2" else "nccl", storage)
    checks = {label: sharded_float64_check(reference, wait_workers(procs))
              for label, procs in runs.items()}
    float64_seconds = time.perf_counter() - t0
    # The production recipe, each run alone on the card.
    big = os.path.join(scratch, "experiment_scale")
    if not os.path.isdir(os.path.join(big, "data")):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.generate_tosses("cube", big, SCALE_TOSSES,
                                cli.TRAJECTORY_LENGTHS["cube"],
                                generation_batch=SCALE_TOSSES)
    scale = {}
    for label, world, backend in (("gloo2", 2, "gloo"), ("nccl1", 1, "nccl")):
        t1 = time.perf_counter()
        readings = wait_workers(launch_workers(
            work, label, "scale", world, backend, big,
            initial_urdf=wrong_init(scratch, "cube")))
        scale[label] = {"seconds": time.perf_counter() - t1,
                        "ranks": readings}
    report = {"phase": "sharded_experiment",
              "cards": torch.cuda.device_count(),
              "note": "one card: the two-rank runs share it over gloo",
              "float64": checks, "float64_seconds": float64_seconds}
    failures = [f"{label} float64: {f}" for label, c in checks.items()
                for f in c.pop("failures")]
    steps = -(-scale["gloo2"]["ranks"][0]["train_slices"] // SCALE_BATCH)
    for label, entry in scale.items():
        world = len(entry["ranks"])
        for rank in entry["ranks"]:
            epochs = rank["epochs"]
            rank["epoch_seconds"] = [e["seconds"] for e in epochs[1:]]
            rank["slices_per_s"] = [rank["train_slices"] / e["seconds"]
                                    for e in epochs[1:]]
            for e in epochs[1:]:
                got = {name: sum(e["launches"][name].values())
                       for name in ("K2", "K3")}
                if got != {"K2": steps, "K3": steps}:
                    failures.append(f"{label} rank {rank['rank']} epoch "
                                    f"{e['epoch']}: launches {got}, "
                                    f"{steps} steps")
            if not sum(rank["evaluation"]["launches"]["K5"].values()):
                failures.append(f"{label} rank {rank['rank']}: the "
                                "evaluation launched no K5")
        report[f"scale_{label}"] = {
            "world": world, "seconds": entry["seconds"],
            "steps_per_epoch": steps, "batch": SCALE_BATCH,
            "rank_batch": SCALE_BATCH // world,
            **{f"rank{r['rank']}": {key: r[key] for key in (
                "epoch_seconds", "slices_per_s", "epochs", "evaluation")}
               for r in entry["ranks"]}}
        if world > 1 and any(r["params"] != entry["ranks"][0]["params"]
                             for r in entry["ranks"][1:]):
            failures.append(f"{label}: the ranks' parameters differ")
    report["seconds"] = time.perf_counter() - t0
    emit(report)
    if failures:
        raise AssertionError("sharded_experiment: " + "; ".join(failures))
    return report


# -- the baselines and the estimators (phase 13) ---------------------------------

#: The deep baseline's recipe (``examples/deep_learnable_baseline.py``):
#: hidden 128, 2 layers, batch 256, lr 1e-3, on 1,024 cube tosses of 80
#: states (generated on the fused rollout, K5 every step). The example
#: runs 200 epochs; 3 here.
DEEP_TOSSES = 1024
DEEP_LENGTH = 80
DEEP_EPOCHS = 3
#: The recurrent model's history: its GRU warms up over 3 states.
DEEP_HISTORY = 4
#: The residual recipe (``examples/residual_physics_cube.py``): 64 dragged
#: tosses, hidden 64, 2 layers, scale 0.1, batch 256, lr 1e-3. The
#: example runs 30 epochs on tosses of 60 states with evaluations of 8
#: trajectories every 15; here 6 epochs (4 steps each) on tosses of 30
#: states (the flight and the first contacts) and the final evaluation
#: only: its rollouts, and the data's, step the vmapped integrator at
#: about 0.4 s a step on an H100 (``PERF.md`` §5).
RESIDUAL_TOSSES = 64
RESIDUAL_LENGTH = 30
RESIDUAL_EPOCHS = 6
#: ``baselines_card_vs_cpu``: one epoch at batch 256 of each model, on 32
#: tosses of 20 states (CARD_CPU_TOSSES, CARD_CPU_LENGTH), float64, with
#: phase 12's bars; the filters at rtol 1e-9.
FILTER_RTOL = 1e-9
FILTER_STEPS = 5


def baseline_experiments(storage: str, device: str, model: str):
    """The deep (``"mlp"``, ``"recurrent"``) or residual experiment of the
    examples on ``storage``: one epoch at batch 256, float64, no per-epoch
    evaluation."""
    import torch
    from dair_pll_tpu_torch.examples import deep_learnable_baseline as deep
    from dair_pll_tpu_torch.examples import residual_physics_cube as residual
    options = dict(epochs=1, device=device, dtype=torch.float64,
                   run_name=f"{model}_{device}")
    if model == "residual":
        return residual.build_experiment(storage=storage, eval_samples=0,
                                         **options)
    history = DEEP_HISTORY if model == "recurrent" else 1
    return deep.build_experiment(model, storage, t_history=history,
                                 full_evaluation_samples=0, **options)


def filter_card_vs_cpu() -> dict:
    """The manifold UKF and the JUKF filtering the linear systems of the
    JAX package's filter tests for FILTER_STEPS steps in float64, on the
    card and on the CPU; the largest relative differences of the states
    and covariances."""
    import numpy as np
    import torch
    from dair_pll_tpu_torch.jukf import JUKF
    from dair_pll_tpu_torch.ukf import ManifoldUKF
    rng = np.random.default_rng(11)
    ys = rng.standard_normal((FILTER_STEPS, 3))
    d = 3
    A_np = np.diag([1.0, 0.95, 1.05]) + 0.1 * np.triu(np.ones((d, d)), 1)
    out = {}
    for device in ("cuda", "cpu"):
        A = torch.as_tensor(A_np, device=device)
        Q = 0.01 * torch.eye(d, dtype=torch.float64, device=device)
        R = 0.1 * torch.eye(d, dtype=torch.float64, device=device)

        def f(state, omega, w, dt):
            return state @ A.T + w

        def add(x, xi):
            return x + xi

        def sub(x1, x2):
            return x2 - x1

        ukf = ManifoldUKF(f=f, h=lambda x: x, phi=add, phi_inv=sub, Q=Q, R=R,
                          alpha=(1.0, 1.0, 1.0), d=d)
        jukf = JUKF(f=f, h=lambda x: x, phi=add, Q=Q, alpha=(1.0,) * 5, d=d,
                    red_idxs=tuple(range(d)), red_phi=add, red_phi_inv=sub,
                    up_idxs=tuple(range(d)), up_phi=add)
        start = torch.tensor([1.0, -0.5, 0.2], dtype=torch.float64,
                             device=device)
        eye = torch.eye(d, dtype=torch.float64, device=device)
        states, Ps = {}, {}
        for name, filt in (("ukf", ukf), ("jukf", jukf)):
            state, P, seq_s, seq_P = start, eye, [], []
            for y in ys:
                y = torch.as_tensor(y, device=device)
                if name == "ukf":
                    state, P = filt.step(state, P, None, y, 0.1)
                else:
                    state, P = filt.step(state, P, None, y, R, 0.1)
                seq_s.append(state.cpu().numpy())
                seq_P.append(P.cpu().numpy())
            states[name], Ps[name] = np.stack(seq_s), np.stack(seq_P)
        out[device] = (states, Ps)

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    return {name: {"state_rel_err": rel(out["cuda"][0][name],
                                        out["cpu"][0][name]),
                   "cov_rel_err": rel(out["cuda"][1][name],
                                      out["cpu"][1][name])}
            for name in ("ukf", "jukf")}


def phase_baselines_card_vs_cpu(scratch: str) -> dict:
    """One epoch of the deep MLP, the recurrent deep model (history
    DEEP_HISTORY) and the residual cube at batch 256 in float64, on the
    card and on the CPU, each on its own copy of one storage of 32 tosses
    of 20 states made on the CPU: equal batch tables, each step's loss
    within CARD_CPU_LOSS_RTOL, the parameters after the epoch within
    phase 12's bars; then the UKF and the JUKF, card against CPU."""
    import shutil
    import numpy as np
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    t0 = time.perf_counter()
    source = os.path.join(scratch, "baselines_source")
    cli.generate_tosses("cube", source, CARD_CPU_TOSSES, CARD_CPU_LENGTH,
                        device="cpu")
    report = {"phase": "baselines_card_vs_cpu", "tosses": CARD_CPU_TOSSES,
              "states": CARD_CPU_LENGTH, "models": {}}
    failures = []
    for model in ("mlp", "recurrent", "residual"):
        runs = {}
        for device in ("cuda", "cpu"):
            storage = os.path.join(scratch, f"baselines_{model}_{device}")
            shutil.copytree(source, storage)
            experiment = baseline_experiments(storage, device, model)
            params_by_epoch = []
            reset_launches()
            t1 = time.perf_counter()
            with EpochRecorder("_build_train_epoch") as recorder, \
                    contextlib.redirect_stdout(io.StringIO()):
                experiment.train(lambda e, p, *a: params_by_epoch.append(
                    [leaf.detach().cpu().numpy().copy()
                     for leaf in p.parameters()]))
            runs[device] = {"records": recorder.records,
                            "params": params_by_epoch,
                            "seconds": time.perf_counter() - t1,
                            "launches": read_launches()}
        card, cpu = runs["cuda"]["records"], runs["cpu"]["records"]
        if len(card) != 1 or len(cpu) != 1 or not np.array_equal(
                card[0]["batches"], cpu[0]["batches"]):
            failures.append(f"{model}: the batch tables differ")
            continue
        a, b = card[0]["losses"], cpu[0]["losses"]
        loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
        param_err = param_err_over_bar(runs["cuda"]["params"][-1],
                                       runs["cpu"]["params"][-1])
        report["models"][model] = {
            "steps": int(len(a)), "step_loss_rel_err": (
                np.abs(a - b) / np.abs(b)).tolist(),
            "max_step_loss_rel_err": loss_rel,
            "param_err_over_bar": param_err,
            "seconds": {d: runs[d]["seconds"] for d in runs},
            "launches": runs["cuda"]["launches"]}
        if loss_rel > CARD_CPU_LOSS_RTOL:
            failures.append(f"{model}: step losses differ by {loss_rel}")
        if param_err > 1.0:
            failures.append(f"{model}: parameters over the bar by "
                            f"{param_err}")
    filters = filter_card_vs_cpu()
    report["filters"] = filters
    for name, errors in filters.items():
        for key, value in errors.items():
            if not value <= FILTER_RTOL:
                failures.append(f"{name}: {key} {value}")
    report["seconds"] = time.perf_counter() - t0
    emit(report)
    if failures:
        raise AssertionError("baselines_card_vs_cpu: " + "; ".join(failures))
    return report


def phase_deep_baseline(scratch: str) -> dict:
    """The deep baseline's recipe on the card: 1,024 cube tosses of 80
    states from ``contactnets_simple.generate_tosses`` (the fused rollout,
    K5 every step), then the MLP (history 1) and the recurrent model
    (history DEEP_HISTORY), hidden 128, 2 layers, batch 256, DEEP_EPOCHS
    epochs each, no per-epoch evaluation, and the final evaluation beside
    the ground-truth cube (its rollouts on K5); each run again, which must
    resume."""
    import torch
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    from dair_pll_tpu_torch.examples import deep_learnable_baseline as deep
    storage = os.path.join(scratch, "deep_baseline")
    reset_launches()
    t0 = time.perf_counter()
    generated = cli.generate_tosses("cube", storage, DEEP_TOSSES,
                                    DEEP_LENGTH,
                                    generation_batch=DEEP_TOSSES)
    torch.cuda.synchronize()
    generation = {"generated": generated,
                  "seconds": time.perf_counter() - t0,
                  "launches": experiment_launches()}
    if generation["launches"]["K5"] != DEEP_LENGTH - 1:
        raise AssertionError(f"deep_baseline: generation launched K5 "
                             f"{generation['launches']['K5']} times, "
                             f"expected {DEEP_LENGTH - 1}")
    report = {"phase": "deep_baseline", "generation": generation}
    idle = {name: 0 for name in EXPERIMENT_KERNELS}
    for kind in ("mlp", "recurrent"):
        history = DEEP_HISTORY if kind == "recurrent" else 1
        options = dict(model_kind=kind, epochs=DEEP_EPOCHS,
                       t_history=history, full_evaluation_samples=0)
        run = run_experiment(f"deep_{kind}", storage, deep.run, **options)
        check_falling(run)
        train_set, valid_set, test_set = run["sets"]
        trajectories = sum(len(s.trajectories) for s in run["sets"])
        slices = sum(s.n_slices for s in run["sets"])
        horizon = train_set.trajectories[0].shape[0] - history
        # Training and its loss passes are matmuls; the final evaluation
        # rolls the ground-truth cube out on K5 (the model's rollouts are
        # the deep system's own).
        final = dict(idle, K5=eval_k5(trajectories, slices, horizon))
        per_epoch = [entry["launches"] for entry in run["epochs"]]
        if run["generation"]["launches"] != idle or \
                any(launches != idle for launches in per_epoch) or \
                run["final_launches"] != final:
            raise AssertionError(
                f"deep_{kind}: launches {per_epoch} a epoch, "
                f"{run['final_launches']} in the final evaluation, "
                f"expected none and {final}")
        if not all(bool(torch.isfinite(leaf).all())
                   for leaf in run["out"]["best_params"].parameters()):
            raise AssertionError(f"deep_{kind}: non-finite parameters")
        report[kind] = {
            "t_history": history, "train_slices": train_set.n_slices,
            "epochs": epoch_table(run),
            "launches": run["final_launches"], "seconds": run["seconds"],
            "means": {key: value for key, value in
                      run["out"]["statistics"].items()
                      if key.endswith("_mean")},
            **rerun_resumes(f"deep_{kind}", storage, deep.run, **options)}
    emit(report)
    return report


def leaves_moved(before, after) -> list:
    import torch
    return [not torch.equal(a.detach().cpu(), b.detach().cpu())
            for a, b in zip(before, after)]


def without_residual(params):
    """The residual cube's parameters with the residual's output layer
    zeroed: its structured half alone, on the same integrator."""
    import torch
    from dair_pll_tpu_torch.params import ParamTree
    residual = params["residual"]
    *hidden, output = residual["net"]
    return ParamTree({**params, "residual": {**residual, "net": [
        *hidden, {key: torch.zeros_like(value)
                  for key, value in output.items()}]}})


def residual_gain(experiment, params) -> dict:
    """Per set (train, valid), the mean one-step prediction loss of the
    residual cube at ``params``, that of its structured half alone
    (``without_residual``) and their ratio."""
    import torch
    system = experiment.learned_system
    gain = {}
    for name, trajectory_set in zip(
            ("train", "valid"),
            experiment.data_manager.get_trajectory_sets()):
        past = experiment._on_device(trajectory_set.slices_past,
                                     experiment.dtype)
        future = experiment._on_device(trajectory_set.slices_future,
                                       experiment.dtype)
        with torch.no_grad():
            full, alone = (float(torch.mean(experiment.prediction_loss(
                system, p, past, future)))
                for p in (params, without_residual(params)))
        gain[name] = {"loss": full, "structured_alone": alone,
                      "ratio": full / alone}
    return gain


def phase_residual_physics(scratch: str) -> dict:
    """The residual recipe on the card: RESIDUAL_TOSSES tosses of
    RESIDUAL_LENGTH states of the dragged cube (the vmapped integrator, no
    kernel), the residual cube trained RESIDUAL_EPOCHS epochs at batch
    256, the final evaluation. Checks: a falling train loss; the
    structured and the residual leaves moved from their initial values;
    at the last reported epoch the residual lowers the one-step loss of
    its own structured half (``residual_gain``) on the train and the valid
    slices; no kernel launched."""
    from dair_pll_tpu_torch.examples import residual_physics_cube as residual
    from dair_pll_tpu_torch.params import tree_from_leaves
    storage = os.path.join(scratch, "residual_physics")
    run = run_experiment("residual_physics", storage, residual.run,
                         epochs=RESIDUAL_EPOCHS, n_pop=RESIDUAL_TOSSES,
                         trajectory_length=RESIDUAL_LENGTH, eval_samples=0)
    out = run["out"]
    experiment = out["experiment"]
    # A fresh build draws the same initial values (the live ones trained
    # in place).
    _, initial = experiment.get_learned_system()
    trained = tree_from_leaves(initial, run["last_params"])
    moved = leaves_moved(initial.parameters(), trained.parameters())
    # Leaves in key order: the residual's, then the structured half's.
    n_structured = len(initial["structured"].parameters())
    residual_moved = moved[:-n_structured]
    structured_moved = moved[-n_structured:]
    # The train loss mixes both halves' changes and is an average over an
    # epoch of moving parameters; the paired losses on fixed slices read
    # the residual's part: the trained residual against its own
    # structured half alone, where the initial residual raises it.
    gain = {"initial": residual_gain(experiment, initial),
            "trained": residual_gain(experiment, trained)}
    failures = []
    losses = [entry["train_loss"] for entry in run["epochs"]]
    if not losses[-1] < losses[0]:
        failures.append(f"train loss did not fall: {losses}")
    if not all(entry["finite"] for entry in run["epochs"]):
        failures.append("non-finite parameters")
    if not any(structured_moved) or not any(residual_moved):
        failures.append(f"leaves moved: structured {structured_moved}, "
                        f"residual {residual_moved}")
    for name, reading in gain["trained"].items():
        if not reading["ratio"] < 1.0:
            failures.append(f"the trained residual does not lower the "
                            f"{name} loss: {reading}")
    launched = [run["generation"]["launches"], run["final_launches"],
                *(entry["launches"] for entry in run["epochs"])]
    if any(any(launches.values()) for launches in launched):
        failures.append(f"kernels launched {launched}; its path runs none")
    report = {"phase": "residual_physics", "generated": out["generated"],
              "generation_seconds": run["generation"]["seconds"],
              "train_slices": run["sets"][0].n_slices,
              "epochs": epoch_table(run),
              "residual_weight_norm": [run["log"][e]["residual_weight_norm"]
                                       for e in sorted(run["log"])],
              "residual_gain": gain,
              "structured_leaves_moved": structured_moved,
              "residual_leaves_moved": residual_moved,
              "seconds": run["seconds"],
              "means": {key: value for key, value in
                        out["statistics"].items() if key.endswith("_mean")}}
    emit(report)
    if failures:
        raise AssertionError("residual_physics: " + "; ".join(failures))
    return report


def size_cover_rows(sizes: dict) -> list:
    """The kernel table's rows of ``size_cover``'s instantiations (each
    built at first use): K5 at (6, 1) and (6, 5), K4 at (6, 1), the
    generic K1, K3 and K2 of the ball's and the box and sphere body's
    sizes, K6 at k = 15."""
    rows = []

    def row(name, source, line, launches, errors, timing, design=None):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dair_pll_tpu_torch/csrc/{source}",
            "replaces": line, "launches": launches,
            "max_abs_err": errors["max_abs_err"],
            "max_abs_err_float64": errors["max_abs_err_float64"],
            "ms": timing["ms"], "ms_float64": timing.get("ms_float64"),
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            **({"bound_ms_float64": timing["bound_ms_float64"]}
               if "bound_ms_float64" in timing else {}),
            **({"design": design} if design else {}),
            **{key: timing[key] for key in ("ptxas", "ptxas_float64")
               if key in timing},
            "library_ms": None})

    for model in ("ball", "box_sphere"):
        entry = sizes[model]
        shape, size = entry["solve_shape"], entry["size"]
        row(f"warm_hybrid_solve_{shape}", "warm_hybrid_solve.cuh",
            "dair_pll_tpu/ops/soa_pallas.py:151",
            entry["rollout"]["launches_by"]["K5"][shape],
            entry["K5_vs_plain"], entry["K5_timing"],
            "one thread a QP (k odd)")
        for kind, kernel, line in (("K1", "contactnets_loss_fwd", 129),
                                   ("K3", "contactnets_loss_fwd_warm", 150),
                                   ("K2", "contactnets_loss_bwd", 180)):
            timing = entry["loss_timing"][kind]
            row(f"{kernel}_{size}", "model_loss.cuh",
                f"dair_pll_tpu/ops/soa_loss_pallas.py:{line}",
                entry["train"]["launches_by"][kind][size],
                entry["loss_kernels_vs_plain"][kind], timing,
                generic_design(size, kind))
    ball = sizes["ball"]["K4"]
    row("cold_hybrid_solve_nv6_k1", "cold_hybrid_solve.cuh",
        "dair_pll_tpu/ops/soa_pallas.py:59",
        ball["launches_by"]["K4"]["nv6_k1"], ball["vs_plain"], ball,
        "one thread a QP (k odd)")
    cubes = sizes["three_cubes"]
    errors = {"max_abs_err": max(cubes[key]["float32_max_abs_err"]
                                 for key in ("K6_vs_plain",
                                             "K6_vs_plain_random")),
              "max_abs_err_float64": max(
                  cubes[key]["float64_max_abs_err"]
                  for key in ("K6_vs_plain", "K6_vs_plain_random"))}
    row("apgd_cone_solve_k15", "apgd_cone_solve.cuh",
        "dair_pll_tpu/ops/pallas_cone_solver.py:45",
        cubes["launches_by"]["k15"], errors, cubes,
        "a warp a problem, two rows a lane")
    return rows


def run_baseline_phases(run) -> dict:
    """Phase 13's three phases, in their order, in a fresh directory of the
    checkout."""
    import shutil
    scratch = os.path.join(HERE, "build", "baseline_smoke")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    run("baselines_card_vs_cpu", phase_baselines_card_vs_cpu, scratch)
    deep = run("deep_baseline", phase_deep_baseline, scratch)
    run("residual_physics", phase_residual_physics, scratch)
    return deep


def main(argv=None) -> int:
    import torch
    flags = sys.argv[1:] if argv is None else argv
    if flags[:1] == ["--sharded-worker"]:
        sys.path.insert(0, HERE)
        return sharded_worker(flags[1])
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

    seconds_of, device_of = {}, {}
    sampler = DeviceSampler()

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        t1 = time.perf_counter()
        seconds_of[name] = t1 - t0
        device_of[name] = sampler.summary(t0, t1)
        return out

    smi = run("device", phase_device)
    run("build", build_kernels)
    start_host_builds()
    if {"--only-experiments", "--only-baselines", "--only-size-cover",
            "--only-sharded"} & set(flags):
        # A shorter run for work on the experiment layer, the baselines,
        # the sizes or the sharded experiment: their phases alone, without
        # the kernel table or the final line.
        if "--only-size-cover" in flags:
            run("size_cover", phase_size_cover)
        if "--only-sharded" in flags:
            run("sharded_experiment", phase_sharded_experiment)
        if "--only-experiments" in flags:
            run_experiment_phases(run)
        if "--only-baselines" in flags:
            run_baseline_phases(run)
        sampler.stop()
        emit({"phase": "seconds", **seconds_of})
        print(smi, flush=True)
        return 0
    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, DT)
    x0_64 = torch.tensor(
        assets.cube_states_near_ground(np.random.default_rng(0), B),
        dtype=torch.float64, device=system.device)
    k = run("kernel_vs_plain+kernel_timing", phase_kernel, system, x0_64)
    traj, launches, seconds = run("rollout", phase_rollout, system, x0_64)
    run("step_breakdown", phase_breakdown, system, traj)

    icnn_system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube_mesh")}, DT)
    x0_icnn = icnn_states(icnn_system,
                          icnn_system.initial_params(torch.float64), B)
    x_icnn, xp_icnn = train_transitions(ICNN_TRAIN_B, icnn_system.device)
    k4 = run("icnn_kernel_vs_plain+icnn_kernel_timing", phase_icnn_kernel,
             icnn_system, x0_icnn, x_icnn, xp_icnn)
    torch.cuda.empty_cache()
    run("icnn_loss_card_vs_cpu", phase_icnn_loss_vs_cpu, icnn_system,
        x0_icnn, x_icnn, xp_icnn)
    run("icnn_rollout", phase_icnn_rollout, icnn_system, x0_icnn)
    k6 = run("apgd_kernel_vs_plain", phase_apgd_kernel, system, x0_64)
    k6.update(run("apgd_kernel_timing", phase_apgd_timing, system))
    run("apgd_divergence", phase_apgd_divergence, system)
    k6_launches = run("vmapped_train", phase_vmapped_train, system)
    run("apgd_kernel_vs_plain_full", phase_apgd_full, system)
    run("vmapped_card_vs_cpu", phase_vmapped_vs_cpu,
        {"cube": system, "icnn_cube": icnn_system},
        {"cube": x0_64, "icnn_cube": x0_icnn}, x_icnn, xp_icnn)
    run("vmapped_rollout", phase_vmapped_rollout, system, x0_64)
    torch.cuda.empty_cache()

    # The elbow's host-bound phases, before the first trace.
    elbow = elbow_system()
    icnn_elbow = elbow_system("elbow_mesh")
    x0_elbow = states_near_ground(elbow, B, 4)
    x0_icnn_elbow = states_near_ground(icnn_elbow, B, 5)
    k45 = run("elbow_kernel_vs_plain", phase_elbow_kernel, elbow,
              icnn_elbow, x0_elbow, x0_icnn_elbow)
    elbow_k5 = run("elbow_rollout", phase_elbow_rollout, elbow, x0_elbow)
    icnn_elbow_launches, k4_main = run(
        "elbow_icnn_loss", phase_elbow_icnn_loss, icnn_elbow, x0_icnn_elbow)
    elbow_k4 = icnn_elbow_launches["K4"]["nv7_k8"]
    k4_rich = run("k4_contact_rich", phase_k4_contact_rich, system, elbow)
    # K4's row: its errors on the rollout's and on the main path's QPs,
    # its times and bound at the main path's shape.
    k45["K4"] = {**k4_main, **{name: max(k45["K4"][name], k4_main[name])
                               for name in ("max_abs_err",
                                            "max_abs_err_float64")}}
    del icnn_elbow, x0_icnn_elbow
    torch.cuda.empty_cache()
    # Every size the TPU kernels take (phase 14), before the first trace.
    sizes = run("size_cover", phase_size_cover)

    # The experiment layer through the CLI's entry points (host-bound but
    # for the production batch's, whose traced epoch comes last).
    experiments = run_experiment_phases(run)
    run("sharded_experiment", phase_sharded_experiment,
        os.path.join(HERE, "build", "experiment_smoke"))
    deep_baseline = run_baseline_phases(run)
    icnn_launches = run("icnn_train", phase_icnn_train, icnn_system, x_icnn,
                        xp_icnn)
    del x_icnn, xp_icnn
    torch.cuda.empty_cache()

    run("profile", phase_profile, system, x0_64, seconds / STEPS)
    loss_errors, transitions = run("loss_kernels_vs_plain",
                                   phase_loss_kernels, system, x0_64)
    x_train, xp_train = train_transitions(TRAIN_B, system.device)
    loss_times = run("loss_kernel_timing", phase_loss_timing, system,
                     transitions, x_train, xp_train)
    run("loss_kernels_vs_plain_full", phase_loss_full_batch, system,
        transitions[2], x_train, xp_train)
    train_launches = run("train", phase_train, system, x_train, xp_train)
    del x_train, xp_train
    torch.cuda.empty_cache()

    # The generic loss kernels: the elbow (box and polygon) and the
    # polygon cube.
    generic = {"elbow": elbow,
               "elbow_polygon": elbow_system(
                   "elbow_mesh", mesh_representation="polygon"),
               "cube_polygon": MultibodyLearnableSystem.from_urdfs(
                   {"cube": assets.get_asset("cube_mesh")}, DT,
                   mesh_representation="polygon")}
    x0s = {name: states_near_ground(model_system, B, 6 + i)
           for i, (name, model_system) in enumerate(generic.items())}
    generic_errors, generic_inputs = run(
        "elbow_loss_kernels_vs_plain", phase_elbow_loss_kernels, generic,
        x0s)
    x_elbow, xp_elbow = elbow_train_transitions(ELBOW_TRAIN_B, elbow.device)
    elbow_times, _ = run("elbow_loss_kernel_timing", phase_elbow_loss_timing,
                         elbow, generic_inputs["elbow"], x_elbow, xp_elbow)
    elbow_launches = run("elbow_train", phase_generic_train, elbow, x_elbow,
                         xp_elbow, "elbow_train", "b2_q8_v7_k8")
    del x_elbow, xp_elbow, generic_inputs
    torch.cuda.empty_cache()
    polygon_launches, polygon_times = run(
        "polygon_cube_train", phase_polygon_train, generic["cube_polygon"])
    torch.cuda.empty_cache()
    run("vmapped_profile", phase_vmapped_profile, system)
    sampler.stop()
    emit({"phase": "seconds", **seconds_of})
    emit({"phase": "device_state", **device_of})

    #: The extra keys of a solve row whose bound its own body's count
    #: gives.
    own_count = ("design", "bound_ms_float64", "operations_per_sample",
                 "operations_plain_per_sample")

    def contact_rich(shape: str) -> dict:
        """K4's readings on its contact-rich set at a size."""
        entry = k4_rich[shape]
        return {"B_contact_rich": entry["B"],
                "ms_contact_rich": entry["ms"],
                "ms_float64_contact_rich": entry["ms_float64"],
                "bound_ms_contact_rich": entry["bound_ms"],
                "bound_ms_float64_contact_rich": entry["bound_ms_float64"],
                "exits_contact_rich": entry["exits"]}
    table = [{
        "name": "warm_hybrid_solve",
        "route": "cuda",
        "source": "dair_pll_tpu_torch/csrc/warm_hybrid_solve.cuh",
        "replaces": "dair_pll_tpu/ops/soa_pallas.py:151",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "max_abs_err_float64": k["max_abs_err_float64"],
        "ms": k["ms"],
        "ms_float64": k["ms_float64"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        **{name: k[name] for name in own_count},
        "experiment_launches": {
            phase: experiment_launch_summary(experiments[phase], "K5")
            for phase in ("experiment", "experiment_scale", "mesh")},
        "baseline_launches": {
            "deep_baseline": {
                "generation": deep_baseline["generation"]["launches"]["K5"],
                **{kind: deep_baseline[kind]["launches"]["K5"]
                   for kind in ("mlp", "recurrent")}}},
        "library_ms": None,
    }]
    for name, entry, line in (
            ("K1", "contactnets_loss_fwd", 129),
            ("K3", "contactnets_loss_fwd_warm", 150),
            ("K2", "contactnets_loss_bwd", 180)):
        table.append({
            "name": entry,
            "route": "cuda",
            "source": "dair_pll_tpu_torch/csrc/contactnets_loss.cuh",
            "replaces": f"dair_pll_tpu/ops/soa_loss_pallas.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": loss_errors[name]["max_abs_err"],
            "max_abs_err_float64": loss_errors[name]["max_abs_err_float64"],
            "ms": loss_times[name]["ms"],
            "ms_float64": loss_times[name]["ms_float64"],
            "design": ("reverse-mode adjoint, one sweep per sample"
                       if name == "K2" else CUBE_K1_DESIGN if name == "K1"
                       else CUBE_FWD_DESIGN),
            "plain_ms": loss_times[name]["plain_ms"],
            "bound_ms": loss_times[name]["bound_ms"],
            "bound_by": loss_times[name]["bound_by"],
            **{key: loss_times[name][key]
               for key in ("bound_ms_float64", "exits")
               if key in loss_times[name]},
            "experiment_launches": {
                phase: experiment_launch_summary(experiments[phase], name)
                for phase in ("experiment", "experiment_scale")},
            "library_ms": None,
        })
    table.append({
        "name": "cold_hybrid_solve",
        "route": "cuda",
        "source": "dair_pll_tpu_torch/csrc/cold_hybrid_solve.cuh",
        "replaces": "dair_pll_tpu/ops/soa_pallas.py:59",
        "launches": icnn_launches["K4"],
        "max_abs_err": k4["max_abs_err"],
        "max_abs_err_float64": k4["max_abs_err_float64"],
        "ms": k4["ms"],
        "ms_float64": k4["ms_float64"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        **{name: k4[name] for name in own_count},
        **contact_rich("nv6_k4"),
        "experiment_launches": {
            "mesh": experiment_launch_summary(experiments["mesh"], "K4")},
        "library_ms": None,
    })
    table.append({
        "name": "apgd_cone_solve",
        "route": "cuda",
        "source": "dair_pll_tpu_torch/csrc/apgd_cone_solve.cuh",
        "replaces": "dair_pll_tpu/ops/pallas_cone_solver.py:45",
        "launches": k6_launches["K6"],
        "max_abs_err": k6["max_abs_err"],
        "max_abs_err_float64": k6["max_abs_err_float64"],
        "ms": k6["ms"],
        "ms_float64": k6["ms_float64"],
        "ms_at_timing_b": k6["at_timing_b"]["ms"],
        "ms_float64_at_timing_b": k6["at_timing_b"]["ms_float64"],
        "design": K6_DESIGN,
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"],
        "library_ms": None,
    })
    for shape_name, source, line, key, launched in (
            ("warm_hybrid_solve_nv7_k8", "warm_hybrid_solve.cuh", 151, "K5",
             elbow_k5),
            ("cold_hybrid_solve_nv7_k8", "cold_hybrid_solve.cuh", 59, "K4",
             elbow_k4)):
        entry = k45[key]
        table.append({
            "name": shape_name,
            "route": "cuda",
            "source": f"dair_pll_tpu_torch/csrc/{source}",
            "replaces": f"dair_pll_tpu/ops/soa_pallas.py:{line}",
            "launches": launched,
            "max_abs_err": entry["max_abs_err"],
            "max_abs_err_float64": entry["max_abs_err_float64"],
            "ms": entry["ms"],
            "ms_float64": entry["ms_float64"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            **{name: entry[name] for name in own_count if name in entry},
            **(contact_rich("nv7_k8") if key == "K4" else {}),
            **({"experiment_launches": {"elbow": experiment_launch_summary(
                experiments["elbow"], "K5")}} if key == "K5" else {}),
            "library_ms": None,
        })
    for size, model_name, launches_of, times in (
            ("b2_q8_v7_k8", "elbow", elbow_launches, elbow_times),
            ("b1_q7_v6_k4", "cube_polygon", polygon_launches,
             polygon_times)):
        for name, entry, line in (
                ("K1", "contactnets_loss_fwd", 129),
                ("K3", "contactnets_loss_fwd_warm", 150),
                ("K2", "contactnets_loss_bwd", 180)):
            errors = generic_errors[model_name][name]
            table.append({
                "name": f"{entry}_{size}",
                "route": "cuda",
                "source": "dair_pll_tpu_torch/csrc/model_loss.cuh",
                "replaces": f"dair_pll_tpu/ops/soa_loss_pallas.py:{line}",
                "launches": launches_of[name],
                "max_abs_err": errors["max_abs_err"],
                "max_abs_err_float64": errors["max_abs_err_float64"],
                "ms": times[name]["ms"],
                **({"ms_float64": times[name]["ms_float64"]}
                   if "ms_float64" in times[name] else {}),
                "design": generic_design(size, name),
                "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound_ms"],
                "bound_by": times[name]["bound_by"],
                **({"experiment_launches": {
                    "elbow": experiment_launch_summary(experiments["elbow"],
                                                       name)}}
                   if model_name == "elbow" else {}),
                "library_ms": None,
            })
    table += size_cover_rows(sizes)
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
