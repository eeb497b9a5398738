"""The cases ``tests/test_torch_parallel.py`` runs in one process and in
two (``tests/torch_parallel_worker.py``): the box cube's data-parallel
training steps and rollout, and the cube experiment with the sharding
flags. Each returns plain lists (JSON), computed the same way on one rank
or on several."""
import numpy as np
import torch

from dair_pll_tpu_torch import assets
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.parallel import sharding

DT = 0.0068
B = 16
STEPS = 3
ROLLOUT_STEPS = 5
#: The experiment: tosses of the cube's recipe, batch 32, two epochs (the
#: warm cache's seed, then a warm epoch) of the fused loss in float64.
N_TOSSES, TOSS_STATES, BATCH = 12, 16, 32


def cube_batch():
    """The JAX package's ``tests/test_parallel.py`` cube batch in float64:
    ``(system, x, x_plus)``."""
    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, DT, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 13))
    x[:, :4] /= np.linalg.norm(x[:, :4], axis=-1, keepdims=True)
    x[:, 6] = 0.06 + 0.05 * rng.random(B)
    xp = x + 0.005 * rng.standard_normal((B, 13))
    xp[:, :4] /= np.linalg.norm(xp[:, :4], axis=-1, keepdims=True)
    return system, torch.tensor(x), torch.tensor(xp)


def _leaves(params):
    return [leaf.detach().flatten().tolist() for leaf in params.parameters()]


def data_parallel_steps(mesh: sharding.Mesh) -> dict:
    """STEPS Adam steps (lr 1e-2) from perturbed parameters on the cube
    batch through ``make_data_parallel_step``: the losses, the first
    step's averaged gradient and the parameters after."""
    system, x, xp = cube_batch()
    params = system.initial_params(torch.float64)
    with torch.no_grad():
        for leaf in params.parameters():
            leaf.mul_(1.15).add_(0.01)
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    sharding.replicate(params, mesh)
    optimizer = torch.optim.Adam(leaves, lr=1e-2)

    def loss_fn(p, x_past, x_future):
        u = x_past.new_zeros((x_past.shape[0], 0))
        return system.contactnets_loss_batch(p, x_past, u, x_future)

    step = sharding.make_data_parallel_step(loss_fn, optimizer, mesh)
    losses, grads = [], None
    for _ in range(STEPS):
        losses.append(float(step(params, x, xp)))
        if grads is None:
            # The step leaves the averaged gradient it applied.
            grads = [leaf.grad.flatten().tolist() for leaf in leaves]
    return {"losses": losses, "grads": grads, "params": _leaves(params)}


def data_parallel_rollout(mesh: sharding.Mesh) -> list:
    """ROLLOUT_STEPS steps of the cube batch's states (the vmapped
    integrator) through ``make_data_parallel_rollout``."""
    system, x, _ = cube_batch()
    params = system.initial_params(torch.float64)
    rollout = sharding.make_data_parallel_rollout(
        lambda p, x0: system.simulate_batch(p, x0, ROLLOUT_STEPS), mesh)
    with torch.no_grad():
        return rollout(params, x[:B - 1]).tolist()


def toss_storage(storage: str) -> None:
    """N_TOSSES simulated cube tosses of TOSS_STATES states in
    ``storage`` (the JAX package's ``_toss_storage`` recipe, rolled out by
    the port in float64, saved in float32)."""
    from dair_pll_tpu_torch.utils import file_utils
    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, DT, device="cpu")
    rng = np.random.default_rng(4)
    quat = rng.standard_normal((N_TOSSES, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    x0 = np.concatenate(
        [quat, 0.02 * rng.standard_normal((N_TOSSES, 2)),
         0.10 + 0.05 * rng.random((N_TOSSES, 1)),
         rng.standard_normal((N_TOSSES, 6)) * [2, 2, 2, 0.5, 0.5, 0.2]],
        axis=-1)
    with torch.no_grad():
        trajectories = system.simulate_batch(
            system.initial_params(torch.float64), torch.tensor(x0),
            TOSS_STATES - 1)
    for i in range(N_TOSSES):
        file_utils.save_trajectory(storage, "learning", i,
                                   trajectories[i].numpy().astype(
                                       np.float32))


def experiment_run(storage: str, shard: bool) -> dict:
    """Two epochs of the cube experiment on ``storage`` (float64, the
    fused warm loss at batch BATCH, no per-epoch evaluation), with or
    without the sharding flags: each epoch's train loss, the best valid
    loss and the parameters; then the learned system's rollouts of the
    first four train trajectories (``trajectory_predict``)."""
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    experiment = cli.build_experiment(
        storage=storage, run_name="sharded" if shard else "unsharded",
        epochs=2, eval_samples=0, batch_size=BATCH, device="cpu",
        dtype=torch.float64, force_fused_loss=True, use_warm_loss=True,
        loss_dtype="float64", shard_training=shard, shard_evaluation=shard)
    losses = []
    train_loss, best_valid, params = experiment.train(
        lambda epoch, p, loss, valid: losses.append(loss))
    train_set = experiment.data_manager.get_trajectory_sets()[0]
    predictions, _, _ = experiment.trajectory_predict(
        experiment.learned_system, params, train_set.trajectories[:4],
        experiment.config.data_config.slice_config.t_skip)
    mesh = experiment.training_mesh(BATCH)
    return {"losses": losses, "train_loss": train_loss,
            "best_valid": best_valid, "params": _leaves(params),
            "predictions": np.asarray(predictions).tolist(),
            "mesh_size": None if mesh is None else mesh.size,
            "writer": experiment.writer}
