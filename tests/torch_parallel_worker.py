"""One rank of ``tests/test_torch_parallel.py``'s two-process runs.

Usage: python tests/torch_parallel_worker.py <port> <world> <rank>
       <storage> <out_json>

The ranks join one gloo process group on the CPU
(``dair_pll_tpu_torch.parallel.multiprocess.initialize``). Each rank runs,
in turn: three data-parallel training steps of the box cube
(``sharding.make_data_parallel_step``, float64, Adam), the averaged
gradient of the first, a data-parallel rollout
(``make_data_parallel_rollout``), and two epochs of the cube experiment
with ``shard_training`` and ``shard_evaluation`` on the tosses in
``storage`` (a copy per rank; rank 0 writes the run's files), then a
sharded evaluation rollout; it writes its readings as JSON.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from dair_pll_tpu_torch.parallel import multiprocess, sharding  # noqa: E402
import torch_parallel_cases as cases  # noqa: E402


def main() -> None:
    port, world, rank, storage, out_path = sys.argv[1:6]
    multiprocess.initialize(f"127.0.0.1:{port}", int(world), int(rank),
                            backend="gloo", timeout_s=120.0, device="cpu")
    out = {"rank": int(rank)}
    mesh = sharding.make_mesh()
    out["step"] = cases.data_parallel_steps(mesh)
    out["rollout"] = cases.data_parallel_rollout(mesh)
    out["experiment"] = cases.experiment_run(storage, shard=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(out_path, "w", encoding="utf-8") as handle:
        json.dump(out, handle)


if __name__ == "__main__":
    main()
