"""How often the cold solve's loops reach their exact fixed points, on the
CPU, before any card time: the shares of IPM and SAP-Newton iterations that
repeat the one before (where ``csrc/hybrid_solve.cuh``'s exits leave the
loop) and the operations the body needs with and without the exits, in
float32 and float64, counted by the host build of the kernels' own code
(``ops/host_adjoint.HostModelTerms``: ``cube_count`` for the box cube's
cold loss kernel K1, ``cold_solve_count`` for the cold solve kernel K4):
with the exits the kernel runs (K1 both loops'; K4 SAP-Newton's, and in
float64 the IPM's too), with both loops' and with none
(``chip_smoke.exit_readings``).

The sets, each of ``--n`` samples at the cold loss's budget (10, 10),
made as ``chip_smoke.py`` makes them:

- ``k1_box_cube_train``: the box cube's training transitions
  (``chip_smoke.train_transitions``) through K1's body;
- ``k4_rollout_nv6_k4`` and ``k4_rollout_nv7_k8``: K4's contact-rich sets,
  the QPs of the box cube's and the elbow's fused rollouts near the ground
  (``chip_smoke.rollout_qps``);
- ``k4_icnn_nv6_k4`` and ``k4_icnn_nv7_k8``: the QPs the ICNN cube's and
  the ICNN elbow's cold loss hands K4 at their initial parameters on their
  training recipes' transitions (``chip_smoke.cold_loss_qps``).

    python3 scripts/count_cold_exits.py [--n 8192] [--threads 4]

Prints one JSON line per set. Needs ``g++``; uses no card.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=8192)
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.ops import host_adjoint
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    host = host_adjoint.HostModelTerms(
        os.path.join(ROOT, "build", "host_model_terms"),
        *cs.host_sizes(cs.DEFAULT_HOST_MODELS))
    n, threads, budget = args.n, args.threads, cs.COLD_BUDGET

    def emit(name, count, extra):
        t0 = time.perf_counter()
        out = {"set": name, "n": n, "budget": list(budget), **extra,
               **cs.exit_readings(count, n, budget)}
        out["count_seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)

    def k4_set(name, qps):
        force = host.cold_solve(*(t.double() for t in qps[:3]), cs.LOSS_EPS,
                                *budget)[0]
        emit(name, lambda dtype, exits: host.cold_solve_count(
            *(t.to(dtype) for t in qps[:3]), cs.LOSS_EPS, *budget,
            threads=threads, exits=cs.k4_exits(dtype, exits)),
             {"contact_share": force.abs().amax(dim=(0, 1)).gt(0)
              .float().mean().item()})

    def system(asset, **kwargs):
        return MultibodyLearnableSystem.from_urdfs(
            {asset.split("_")[0]: assets.get_asset(asset)}, cs.DT,
            device="cpu", **kwargs)

    cube = system("cube")
    x, x_plus = cs.train_transitions(n, "cpu")
    pvec = cs.derived_vector(cube, cube.initial_params(torch.float32))
    xin, xp = x.T.contiguous(), x_plus.T.contiguous()
    force = host.cube_loss(pvec, xin, xp, cs.DT, cs.LOSS_EPS, *budget)[1]
    emit("k1_box_cube_train", lambda dtype, exits: host.cube_count(
        "cold", *(t.to(dtype) for t in (pvec, xin, xp)), None, cs.DT,
        cs.LOSS_EPS, *budget, threads=threads, exits=bool(exits)),
         {"contact_share": force.abs().amax(dim=(0, 1)).gt(0).float()
          .mean().item()})

    params = cube.initial_params(torch.float64)
    x0 = torch.tensor(assets.cube_states_near_ground(
        np.random.default_rng(0), n), dtype=torch.float64)
    k4_set("k4_rollout_nv6_k4", cs.rollout_qps(cube, params, x0))
    elbow = system("elbow")
    k4_set("k4_rollout_nv7_k8", cs.rollout_qps(
        elbow, elbow.initial_params(torch.float64),
        cs.states_near_ground(elbow, n, 4)))
    icnn_cube = system("cube_mesh")
    k4_set("k4_icnn_nv6_k4", cs.cold_loss_qps(
        icnn_cube, icnn_cube.initial_params(torch.float32),
        *cs.train_transitions(n, "cpu")))
    icnn_elbow = system("elbow_mesh")
    k4_set("k4_icnn_nv7_k8", cs.cold_loss_qps(
        icnn_elbow, icnn_elbow.initial_params(torch.float32),
        *cs.elbow_train_transitions(n, "cpu")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
