"""K5 and K4 at every contact count of a model's QPs, against the plain
versions, on one card.

The box and sphere body's rollout QPs (``chip_smoke.size_systems``, its
near-ground states at 8,192, steps 4 to 5 of its float64 fused rollout,
the rollout budget (14, 6) at eps 1e-4) cut to their first k contacts for
k = 1 .. 5 (each a QP of (n_v, k) = (6, k): the plane witnesses of the
box, then the sphere's), and the same QPs solved cold at (10, 10): each
instantiation (built at first use, one ``nvcc`` each, all at once)
against ``soa_kernels.plain_packed`` / ``plain_packed_cold`` in float64:
the largest difference, how many QPs differ, and the worst QPs' inputs
and outputs saved to ``chiprun_out/probe_sizes_k<k>.pt`` for a replay in
the host build (``ops/host_adjoint.HostModelTerms``).

    python3 scripts/probe_sizes.py

Needs one CUDA card and ``nvcc``; prints one JSON line per size.

    python3 scripts/probe_sizes.py --replay-k3 SAMPLES.pt

replays float64 K3 samples that parted from the plain version: a file
of the box and sphere body's derived vector ``pvec``, transitions ``xin``,
``xp`` (batch-minor), warm start ``fprev`` and the losses ``kernel`` and
``card_plain`` that an earlier run read on them. It prints the plain
version on the CPU against those losses, and, with a card, the K3 kernel
and the plain version on the card today on the same samples, and whether
the samples are among the transitions that ``chip_smoke.py``'s
``size_cover`` checks today (the nearest of its 8,192 states).
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def replay_k3(path: str) -> int:
    """``--replay-k3``: see the module docstring."""
    import torch
    import chip_smoke as cs
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
    saved = torch.load(path)
    directory = os.path.join(ROOT, "build", "size_cover")
    os.makedirs(directory, exist_ok=True)
    urdf = os.path.join(directory, "box_sphere.urdf")
    with open(urdf, "w", encoding="utf-8") as handle:
        handle.write(cs.SIZE_URDFS["box_sphere"])
    args = (cs.DT, cs.LOSS_EPS, *cs.WARM_BUDGET)
    inputs = [saved[key] for key in ("pvec", "xin", "xp", "fprev")]
    cpu = MultibodyLearnableSystem.from_urdfs({"box_sphere": urdf}, cs.DT,
                                              device="cpu")
    with torch.no_grad():
        ref = lk.plain_loss_fwd_warm(cpu.model, *inputs, *args)[0]
    out = {"saved_kernel_vs_cpu": (saved["kernel"] - ref).tolist(),
           "saved_card_plain_vs_cpu": (saved["card_plain"] - ref).tolist()}
    if torch.cuda.is_available():
        system = MultibodyLearnableSystem.from_urdfs({"box_sphere": urdf},
                                                     cs.DT)
        card = [t.to(system.device) for t in inputs]
        with torch.no_grad():
            kernel = lk.fused_loss_fwd_warm(system.model, *card, *args)[0]
            plain = lk.plain_loss_fwd_warm(system.model, *card, *args)[0]
        x64, _ = cs.model_transitions(
            system, cs.states_near_ground(system, cs.B, 21))
        nearest = (x64[:, None, :] - card[1].T[None]).abs().amax(-1)
        distance, index = nearest.min(0)
        out.update(kernel_vs_cpu=(kernel.cpu() - ref).tolist(),
                   card_plain_vs_cpu=(plain.cpu() - ref).tolist(),
                   kernel_vs_saved_kernel=(kernel.cpu() - saved["kernel"])
                   .tolist(),
                   nearest_state_today=index.tolist(),
                   nearest_state_distance=distance.tolist())
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--replay-k3"]:
        return replay_k3(sys.argv[2])
    import torch
    import chip_smoke as cs
    from dair_pll_tpu_torch.ops import soa_kernels
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    system = cs.size_systems()["box_sphere"]
    x0 = cs.states_near_ground(system, cs.B, 21)
    m, jc, qc, w0 = cs.rollout_qps(
        system, system.initial_params(torch.float64), x0)
    ks = range(1, system.model.n_contacts + 1)
    soa_kernels.build_instances(
        [make(6, k, torch.float64) for k in ks
         for make in (soa_kernels.warm_instance, soa_kernels.cold_instance)])
    for k in ks:
        sub = (m, jc[:, :, :k].contiguous(), qc[:, :k].contiguous())
        for kind, kernel, plain, args, extra in (
                ("K5", soa_kernels.solve_warm_hybrid_soa_cuda_packed,
                 soa_kernels.plain_packed, (cs.EPS, *cs.BUDGET), (w0,)),
                ("K4", soa_kernels.solve_contact_impulse_soa_cuda_packed,
                 soa_kernels.plain_packed_cold,
                 (cs.LOSS_EPS, *cs.COLD_BUDGET), ())):
            with torch.no_grad():
                got = kernel(*sub, *extra, *args)
                want = plain(*sub, *extra, *args)
            torch.cuda.synchronize()
            err = (got[0] - want[0]).abs().amax(dim=(0, 1))
            worst = err.topk(8).indices
            torch.save({"qps": [t[..., worst].cpu() for t in sub + extra],
                        "kernel": [t[..., worst].cpu() for t in got],
                        "plain": [t[..., worst].cpu() for t in want],
                        "args": args},
                       os.path.join(out_dir, f"probe_sizes_{kind}_k{k}.pt"))
            print(json.dumps({
                "kernel": kind, "k": k, "max_abs_err": err.max().item(),
                "n_differ": int((err > 1e-9).sum()),
                "valid_equal": bool(torch.equal(got[-1], want[-1])),
                "worst": worst.tolist()[:4],
                "worst_err": err[worst].tolist()[:4]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
