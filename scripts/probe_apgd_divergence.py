"""Float32 APGD divergence, decided against the JAX package on the CPU.

Regenerates ``chip_smoke.py``'s divergence problems (``random_psd_qps``:
random k = 4 cone QPs of the JAX package's recipe, ``Q = A A' + ridge I``,
``q = 2 N(0, 1)``, seed 44) at ``--n`` problems and a ridge, solves them
all with the port's plain K6 (``cone_kernels.plain_apgd``, 200 iterations)
in float32 and float64 on the CPU, and replays up to ``--replay`` of them
(every float32 divergence first, then the first others) in the JAX
package's Pallas kernel, ``solve_cone_qp_pallas(..., interpret=True)``, in
both types. A solution diverged when it is not finite or exceeds 1e3 (the
solve's failure mask). Prints one JSON line: the shares diverged by each
solver and type, the replayed indices, and the largest gap between the
port's and JAX's solutions on the replayed problems the two both solved.

    JAX_PLATFORMS=cpu python scripts/probe_apgd_divergence.py \\
        --ridge 1e-4 [--n 262144] [--replay 256]

The port's float32 plain version is the card's K6 bit for bit wherever
``chip_smoke.py``'s ``apgd_divergence`` phase reports
``float32_kernel_equals_plain``, so the indices it finds are the card's.
CPU only; the 262,144 problems take a few minutes and some 2 GB.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ITERATIONS = 200
CHUNK = 16384


def problems(n: int, ridge: float):
    """``chip_smoke.random_psd_qps(n, 4, ...)``'s problems, float64
    numpy."""
    import numpy as np
    rng = np.random.default_rng(44)
    A = rng.standard_normal((n, 12, 12))
    Q = A @ np.swapaxes(A, -1, -2) + ridge * np.eye(12)
    q = 2.0 * rng.standard_normal((n, 12))
    return Q, q


def diverged(x):
    """Per problem: the solution is not finite or exceeds 1e3."""
    import numpy as np
    return ~(np.isfinite(x).all(axis=-1) & (np.abs(x) <= 1e3).all(axis=-1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=262144)
    parser.add_argument("--ridge", type=float, default=1e-4)
    parser.add_argument("--replay", type=int, default=256)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch
    from dair_pll_tpu.ops.pallas_cone_solver import solve_cone_qp_pallas
    from dair_pll_tpu_torch.ops import cone_kernels

    t0 = time.perf_counter()
    Q, q = problems(args.n, args.ridge)
    port = {}
    for dtype in (torch.float32, torch.float64):
        Qt, qt = (torch.tensor(a, dtype=dtype) for a in (Q, q))
        with torch.no_grad():
            port[dtype] = torch.cat([cone_kernels.plain_apgd(
                Qt[s:s + CHUNK], qt[s:s + CHUNK], ITERATIONS)
                for s in range(0, args.n, CHUNK)]).numpy()
    bad32 = np.flatnonzero(diverged(port[torch.float32]))
    rest = np.setdiff1d(np.arange(args.n), bad32)
    replay = np.concatenate((bad32, rest))[:args.replay]
    out = {"n": args.n, "ridge": args.ridge, "iterations": ITERATIONS,
           "port_float32_diverged": int(bad32.size),
           "port_float64_diverged": int(diverged(port[torch.float64]).sum()),
           "port_float32_diverged_first": bad32[:64].tolist(),
           "replayed": int(replay.size)}
    for dtype, jdtype, key in ((torch.float32, jnp.float32, "float32"),
                               (torch.float64, jnp.float64, "float64")):
        got = np.asarray(solve_cone_qp_pallas(
            jnp.asarray(Q[replay], jdtype), jnp.asarray(q[replay], jdtype),
            ITERATIONS, True))
        mine = port[dtype][replay]
        both = ~diverged(got) & ~diverged(mine)
        out[f"jax_{key}_diverged_of_replayed"] = int(diverged(got).sum())
        out[f"port_{key}_diverged_of_replayed"] = int(diverged(mine).sum())
        out[f"jax_{key}_diverged_where_port_did"] = int(
            (diverged(got) & diverged(mine)).sum())
        out[f"{key}_max_gap_where_both_solved"] = float(np.max(
            np.abs(got[both] - mine[both]) / (1 + np.abs(mine[both])),
            initial=0.0))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
