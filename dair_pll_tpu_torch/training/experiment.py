r"""Supervised learning experiment: the training and evaluation loop
(PyTorch).

Counterpart of ``dair_pll_tpu/training/experiment.py`` (reference
``experiment.py:126-851``):

* **Epoch.** JAX runs an epoch as one jitted ``lax.scan``; here it is a
  Python loop over the batch table of :meth:`_epoch_permutation` (a copy
  of JAX's, so that both packages draw the same tables): gather the batch
  with ``index_select`` from slices moved to the device once per run,
  mean loss, ``backward``, optimizer step. The step losses stay on the
  device and are read once per epoch.
* **Epoch-warm loss.** The per-slice solver cache lives on the device;
  each step gathers its batch's entries and scatters the refreshed ones
  back with ``index_copy_`` (wraparound duplicates carry bit-identical
  values: the kernels are deterministic). It is seeded at the full budget
  in the first epoch of a process run and every ``warm_seed_period``
  epochs.
* **Optimizer.** ``torch.optim.Adam`` (``AdamW`` when ``wd > 0``) with
  optax's semantics, see :class:`TrainingOptimizer`.
* **Evaluation.** Per-epoch and final evaluation, with the statistics keys
  ``{set}_{system}_{variable}(_mean)`` of the reference
  (``experiment.py:685-796``); rollouts run through the system's
  ``simulate_batch`` without gradients (the fused rollout on K5 from 1,024
  trajectories, the vmapped integrator below); a host-stepped system (the
  MuJoCo oracle) rolls out one trajectory at a time on the host.
* **Checkpoint/resume** restores the split, parameters, optimizer state,
  epoch counters and run id (reference ``experiment.py:490-557``).

Losses are callbacks ``(params, x_past, x_future) -> (batch,)``.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.data.management import (ExperimentDataManager,
                                                TrajectorySet)
from dair_pll_tpu_torch.multibody.learnable_system import resolve_device
from dair_pll_tpu_torch.parallel import sharding
from dair_pll_tpu_torch.params import dtype_device, tree_from_leaves
from dair_pll_tpu_torch.system import System
from dair_pll_tpu_torch.training.config import (
    OptimizerConfig, SupervisedLearningExperimentConfig)
from dair_pll_tpu_torch.utils import file_utils
from dair_pll_tpu_torch.utils.checkpoint import (TrainingState,
                                                 load_checkpoint,
                                                 save_checkpoint, to_device)
from dair_pll_tpu_torch.utils.logging_manager import ExperimentLogManager

# Statistics naming scheme (reference experiment.py:58-86).
TRAIN_SET = "train"
VALID_SET = "valid"
TEST_SET = "test"
TRAIN_TIME_SETS = (TRAIN_SET, VALID_SET)
ALL_SETS = (TRAIN_SET, VALID_SET, TEST_SET)
BASE_SYSTEM_NAME = "base"
ORACLE_SYSTEM_NAME = "oracle"
LEARNED_SYSTEM_NAME = "model"
LOSS_NAME = "loss"
TRAJECTORY_ERROR_NAME = "trajectory_mse"
PREDICTED_VELOCITY_SIZE = "v_plus_squared"
DELTA_VELOCITY_SIZE = "delta_v_squared"
TARGET_NAME = "target_sample"
PREDICTION_NAME = "prediction_sample"
AVERAGE_TAG = "mean"
#: Count of non-finite per-trajectory entries excluded from the ``_mean``
#: summary (diverged rollouts under bad parameters).
DIVERGED_TAG = "n_diverged"
TRAINING_DURATION = "training_duration"
EVALUATION_DURATION = "evaluation_duration"
LOGGING_DURATION = "logging_duration"
MAX_SAVED_TRAJECTORIES = 5
EVALUATION_VARIABLES = (LOSS_NAME, TRAJECTORY_ERROR_NAME)

#: Chunk size bounding peak memory of per-slice evaluation losses. The
#: JAX package's is 1,024 (its vmapped rollout keeps every chunk's
#: intermediates); the port's rollouts hold no autograd graph, and the
#: fused one is host-bound per call, so its chunk is larger.
EVALUATION_SLICE_CHUNK = 65536

LossCallback = Callable[[Any, Tensor, Tensor], Tensor]
EpochCallback = Callable[[int, Any, float, float], None]


def default_epoch_callback(epoch: int, params: Any, train_loss: float,
                           best_valid_loss: float) -> None:
    """Prints progress (reference ``experiment.py:115-119``)."""
    print(epoch, train_loss, best_valid_loss, flush=True)


def cosine_decay(step: int, decay_steps: int, alpha: float) -> float:
    """optax's ``cosine_decay_schedule`` factor at update ``step``:
    ``(1 - alpha) * 0.5 * (1 + cos(pi * min(step, T) / T)) + alpha``."""
    fraction = min(step, decay_steps) / decay_steps
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * fraction)) + alpha


class TrainingOptimizer:
    """Adam (AdamW when ``wd > 0``) on a list of leaf tensors with the
    semantics of the JAX package's optax chain (``build_optimizer``):

    * a leaf whose ``.grad`` is ``None`` steps with a zero gradient (optax
      updates every leaf: its moments and weight decay move);
    * the update mask multiplies the gradients first;
    * with ``grad_clip > 0``, non-finite gradient entries become 0 and the
      gradients are scaled by ``grad_clip / norm`` unless their global norm
      is below ``grad_clip`` (``optax.clip_by_global_norm``, written out:
      ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
    * with ``decay_steps``, the learning rate follows optax's cosine decay
      (a ``LambdaLR`` stepped after every update).
    """

    def __init__(self, config: OptimizerConfig, leaves: Sequence[Tensor],
                 decay_steps: Optional[int] = None) -> None:
        self.leaves = list(leaves)
        self.grad_clip = float(config.grad_clip)
        lr = float(config.lr.value)
        wd = float(config.wd.value)
        if wd > 0:
            self.optimizer = torch.optim.AdamW(self.leaves, lr=lr,
                                               weight_decay=wd)
        else:
            self.optimizer = torch.optim.Adam(self.leaves, lr=lr)
        self.scheduler = None
        if decay_steps is not None:
            alpha = float(config.cosine_alpha)
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer,
                lambda step: cosine_decay(step, decay_steps, alpha))

    def gradients(self, mask: Optional[Sequence[Tensor]] = None
                  ) -> List[Tensor]:
        """The gradients the update applies, after mask, sanitising and
        clipping."""
        grads = [leaf.grad if leaf.grad is not None else
                 torch.zeros_like(leaf) for leaf in self.leaves]
        if mask is not None:
            grads = [g * m for g, m in zip(grads, mask)]
        if self.grad_clip > 0.0:
            grads = [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
                     for g in grads]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, (g / norm) * self.grad_clip)
                     for g in grads]
        return grads

    def step(self, mask: Optional[Sequence[Tensor]] = None) -> None:
        """One update from the leaves' ``.grad``; clears them after."""
        for leaf, grad in zip(self.leaves, self.gradients(mask)):
            leaf.grad = grad
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        """A copy of the optimizer's (and the schedule's) state."""
        state = {"optimizer": copy.deepcopy(self.optimizer.state_dict())}
        if self.scheduler is not None:
            state["scheduler"] = copy.deepcopy(self.scheduler.state_dict())
        return state

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None and "scheduler" in state:
            self.scheduler.load_state_dict(state["scheduler"])


def build_optimizer(config: OptimizerConfig, leaves: Sequence[Tensor],
                    decay_steps: Optional[int] = None) -> TrainingOptimizer:
    """The training optimizer over ``leaves`` (see
    :class:`TrainingOptimizer`)."""
    return TrainingOptimizer(config, leaves, decay_steps)


def summarize_statistics(stats: Dict) -> Dict:
    """``{key}_mean`` summaries over per-trajectory statistic vectors,
    over the finite entries; the count of excluded non-finite entries is
    reported as ``{key}_n_diverged`` when nonzero (reference
    ``experiment.py:685-796``)."""
    summary: Dict = {}
    for key, value in stats.items():
        if isinstance(value, np.ndarray) and value.ndim == 1 and \
                value.size:
            arr = value
        elif isinstance(value, list) and value and \
                isinstance(value[0], float):
            arr = np.asarray(value)
        else:
            continue
        finite = np.isfinite(arr)
        if bool(finite.all()):
            summary[f"{key}_{AVERAGE_TAG}"] = float(np.mean(arr))
        else:
            summary[f"{key}_{AVERAGE_TAG}"] = (
                float(np.mean(arr[finite])) if bool(finite.any())
                else float("nan"))
            summary[f"{key}_{DIVERGED_TAG}"] = int((~finite).sum())
    return summary


def snapshot(params: Any) -> Any:
    """A detached copy of parameters."""
    return params.map(lambda leaf: leaf.detach().clone())


class SupervisedLearningExperiment:
    """Trains a learnable system on trajectory data.

    Subclasses implement :meth:`get_base_system` and
    :meth:`get_learned_system`, and may override :meth:`loss_callback`
    (default: the velocity-MSE prediction loss, reference
    ``experiment.py:292-320``).

    Args:
        config: the experiment configuration.
        device: where the systems run; ``None`` is the CUDA card, as for
          ``MultibodyLearnableSystem``.
        dtype: the parameters' dtype (the JAX package's are float32); the
          slices and the evaluation rollouts take it.
    """

    def __init__(self, config: SupervisedLearningExperimentConfig,
                 device=None, dtype=torch.float32) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype
        self.learned_system: Optional[System] = None
        self.data_manager: Optional[ExperimentDataManager] = None
        self.log_manager: Optional[ExperimentLogManager] = None
        #: Whether this process writes the run's files: rank 0 of a
        #: process group (every rank runs the experiment; see
        #: :meth:`training_mesh`), or the only process.
        self.writer = sharding.rank() == 0
        if self.writer:
            file_utils.save_config(config.storage, config.run_name, config)

    # -- abstract system factories ------------------------------------------
    def get_base_system(self) -> Tuple[System, Any]:
        """The ground-truth (oracle) system and its parameters."""
        raise NotImplementedError

    def get_learned_system(self) -> Tuple[System, Any]:
        """The learnable system and its initial parameters."""
        raise NotImplementedError

    def get_oracle_system(self) -> Tuple[System, Any]:
        """System used as the evaluation oracle; defaults to the base."""
        return self.get_base_system()

    @property
    def space(self):
        assert self.learned_system is not None
        return self.learned_system.space

    def evaluation_mesh(self) -> Optional[sharding.Mesh]:
        """The data-parallel mesh of the evaluation rollouts, or ``None``:
        with ``config.shard_evaluation`` and a process group of more than
        one rank, every rank rolls out its share of each batch of
        trajectories (:meth:`_rollout`)."""
        if not self.config.shard_evaluation or sharding.world_size() <= 1:
            return None
        return sharding.make_mesh()

    def training_mesh(self, batch_size: int) -> Optional[sharding.Mesh]:
        """The data-parallel mesh of the training epochs, or ``None``.

        With ``config.shard_training`` every minibatch splits across the
        mesh's ranks, the parameters stay equal on every rank and the
        gradients are averaged over the mesh before the (identical) Adam
        update on every rank. The mesh is the largest count of ranks that
        divides ``batch_size``, so that each rank's share is equal; the
        other ranks join the collectives with zeros. With no process group
        or one rank the run is unsharded, as the JAX package's
        ``training_mesh`` returns ``None`` on one device."""
        if not self.config.shard_training:
            return None
        n_ranks = sharding.world_size()
        while n_ranks > 1 and batch_size % n_ranks != 0:
            n_ranks -= 1
        if n_ranks <= 1:
            return None
        return sharding.make_mesh(n_ranks)

    def params_from_leaves(self, init_params: Any, leaves: Sequence) -> Any:
        """Stored numpy leaves (a checkpoint's) in the structure, dtype and
        device of ``init_params``."""
        return tree_from_leaves(init_params, leaves)

    def _params_dtype(self, params: Any) -> torch.dtype:
        """The dtype of a system's parameters (the experiment's for a host
        simulator's ``None``)."""
        return dtype_device(params, self.dtype)[0]

    # -- losses ---------------------------------------------------------------
    @staticmethod
    def _velocity_loss(space, x_predicted: Tensor,
                       x_future: Tensor) -> Tensor:
        """Per-slice mean squared velocity error of ``(B, T, n_x)``
        predictions."""
        n_batch, t_prediction = x_future.shape[0], x_future.shape[-2]
        per_element = space.velocity_square_error(
            space.v(x_future).reshape(n_batch, -1, space.n_v),
            space.v(x_predicted).reshape(n_batch, -1, space.n_v))
        return torch.sum(per_element, dim=-1) / (t_prediction * space.n_v)

    def prediction_loss(self, system: System, params: Any, x_past: Tensor,
                        x_future: Tensor) -> Tensor:
        r"""Velocity-MSE prediction loss per slice (reference
        ``experiment.py:292-320``): roll the system forward
        ``t_prediction`` steps from the history (the vmapped integrator,
        differentiable) and average the squared velocity error per
        element. ``x_past (B, t_history, n_x)``, ``x_future (B,
        t_prediction, n_x)`` to ``(B,)``."""
        x_0, carry = system.preprocess_initial_condition(
            params, x_past, system.initial_carry(x_past[..., -1, :]))
        trajectory = system.simulate(params, x_0, x_future.shape[-2],
                                     carry_0=carry)
        return self._velocity_loss(system.space, trajectory[..., 1:, :],
                                   x_future)

    def loss_callback(self) -> LossCallback:
        """Training loss: ``(params, x_past, x_future) -> (B,)``."""
        system = self.learned_system

        def loss(params, x_past, x_future):
            return self.prediction_loss(system, params, x_past, x_future)

        return loss

    def parameter_update_mask(self, params: Any) -> Optional[Any]:
        """Optional 0/1 parameters multiplying gradients before the
        optimizer update; ``None`` means no masking."""
        del params
        return None

    def warm_loss_callback(self):
        """Optional epoch-warm training loss (``None``: not supported).

        Subclasses that support it return ``(make_warm_fn, init_cache)``:

        * ``init_cache(n_slices, dtype, device) -> Tensor``: the per-slice
          solver cache, sample axis last;
        * ``make_warm_fn(seed: bool)``: ``fn(params, x_past, x_future,
          cache_slice) -> (losses (B,), new_cache_slice)``; with
          ``seed=True`` a solve from scratch at the full budget, else
          warm-started from the cache at a reduced budget.
          ``new_cache_slice`` is detached.
        """
        return None

    # -- setup ---------------------------------------------------------------
    def setup_training(self) -> Tuple[TrainingOptimizer, TrainingState]:
        """Builds systems, data and optimizer, and resumes from the
        checkpoint if present (reference ``experiment.py:490-557``).
        ``state.current_params`` are the live parameters the optimizer
        steps."""
        config = self.config
        ckpt_path = file_utils.checkpoint_path(config.storage,
                                               config.run_name)
        state = load_checkpoint(ckpt_path)

        self.data_manager = ExperimentDataManager(
            config.storage, config.data_config,
            split_indices=state.split_indices if state else None)

        self.learned_system, init_params = self.get_learned_system()
        decay_steps = None
        if config.optimizer_config.lr_schedule == "cosine":
            # Cosine decay over the whole epoch budget in optimizer steps,
            # counted from the current dataset size, as in the JAX
            # package.
            train_set, _, _ = self.data_manager.get_trajectory_sets()
            n_slices = max(1, len(train_set.slices_past))
            batch = min(config.optimizer_config.batch_size.value, n_slices)
            decay_steps = -(-n_slices // batch) * max(
                1, config.optimizer_config.epochs)

        if state is None:
            params = init_params
        else:
            params = self.params_from_leaves(init_params,
                                             state.current_params)
        for leaf in params.parameters():
            leaf.requires_grad_(True)
        if sharding.world_size() > 1 and (config.shard_training or
                                          config.shard_evaluation):
            # Every rank starts from rank 0's parameters.
            sharding.replicate(params, sharding.make_mesh())
        optimizer = build_optimizer(config.optimizer_config,
                                    params.parameters(), decay_steps)
        if state is None:
            state = TrainingState(
                split_indices=self.data_manager.trajectory_set_indices(),
                best_params=snapshot(params),
                current_params=params,
                optimizer_state=optimizer.state_dict(),
            )
        else:
            state.best_params = self.params_from_leaves(init_params,
                                                        state.best_params)
            optimizer.load_state_dict(to_device(state.optimizer_state,
                                                self.device))
            state.current_params = params
            state.optimizer_state = optimizer.state_dict()

        self.log_manager = ExperimentLogManager(
            config.storage, config.run_name, use_wandb=config.run_wandb,
            wandb_project=config.wandb_project, resume_id=state.run_id)
        state.run_id = self.log_manager.run_id
        return optimizer, state

    # -- epochs --------------------------------------------------------------
    def _build_train_epoch(self, optimizer: TrainingOptimizer,
                           batch_size: int):
        """``(epoch_fn, eval_epoch_fn)``.

        ``epoch_fn(params, optimizer, past, future, batches)`` trains one
        epoch over the ``(n_batches, batch_size)`` index table and returns
        the step losses ``(n_batches,)`` on the device.
        ``eval_epoch_fn(params, past, future, batches, weights)`` is the
        exact per-slice average of the loss without gradients (wraparound
        duplicates carry weight 0), a 0-d tensor."""
        del optimizer
        loss_fn = self.loss_callback()
        mesh = self.training_mesh(batch_size)

        def epoch_fn(params, optimizer, past, future, batches):
            update_mask = self.parameter_update_mask(params)
            mask = update_mask.parameters() if update_mask is not None \
                else None
            losses = []
            for batch_indices in batches:
                if mesh is not None:
                    batch_indices = sharding.shard_batch(batch_indices, mesh)
                if mesh is None or mesh.participates:
                    x_past = past.index_select(0, batch_indices)
                    x_future = future.index_select(0, batch_indices)
                    loss = torch.mean(loss_fn(params, x_past, x_future))
                    loss.backward()
                else:
                    loss = past.new_zeros(())
                if mesh is not None:
                    sharding.mean_gradients(params.parameters(), mesh)
                    loss = sharding.mean_over_mesh(loss.detach(), mesh)
                optimizer.step(mask)
                losses.append(loss.detach())
            return torch.stack(losses)

        def eval_epoch_fn(params, past, future, batches, batch_weights):
            loss_sum = weight_sum = past.new_zeros(())
            with torch.no_grad():
                for batch_indices, w in zip(batches, batch_weights):
                    if mesh is not None:
                        batch_indices = sharding.shard_batch(batch_indices,
                                                             mesh)
                        w = sharding.shard_batch(w, mesh)
                    if mesh is not None and not mesh.participates:
                        continue
                    x_past = past.index_select(0, batch_indices)
                    x_future = future.index_select(0, batch_indices)
                    losses = loss_fn(params, x_past, x_future)
                    loss_sum = loss_sum + torch.sum(losses * w)
                    weight_sum = weight_sum + torch.sum(w)
            if mesh is not None:
                sums = sharding.all_reduce_sum(
                    torch.stack([loss_sum, weight_sum.to(loss_sum.dtype)]),
                    mesh)
                loss_sum, weight_sum = sums[0], sums[1]
            return loss_sum / torch.clamp(weight_sum, min=1.0)

        return epoch_fn, eval_epoch_fn

    def _build_warm_train_epoch(self, optimizer: TrainingOptimizer,
                                batch_size: int, seed: bool):
        """``epoch_fn(params, optimizer, cache, past, future, batches)``:
        an epoch of the warm loss (:meth:`warm_loss_callback`). Each step
        gathers its batch's cache entries and scatters the refreshed ones
        back in place; returns the step losses on the device."""
        del optimizer
        warm = self.warm_loss_callback()
        assert warm is not None
        make_warm_fn, _ = warm
        warm_fn = make_warm_fn(seed)
        mesh = self.training_mesh(batch_size)

        def epoch_fn(params, optimizer, cache, past, future, batches):
            update_mask = self.parameter_update_mask(params)
            mask = update_mask.parameters() if update_mask is not None \
                else None
            losses = []
            for batch_indices in batches:
                mine = batch_indices if mesh is None else \
                    sharding.shard_batch(batch_indices, mesh)
                if mesh is None or mesh.participates:
                    x_past = past.index_select(0, mine)
                    x_future = future.index_select(0, mine)
                    cache_b = cache.index_select(-1, mine)
                    step_losses, new_cache_b = warm_fn(params, x_past,
                                                       x_future, cache_b)
                    loss = torch.mean(step_losses)
                    loss.backward()
                    new_cache_b = new_cache_b.detach()
                else:
                    loss = past.new_zeros(())
                    new_cache_b = cache.index_select(-1, mine)
                if mesh is not None:
                    sharding.mean_gradients(params.parameters(), mesh)
                    loss = sharding.mean_over_mesh(loss.detach(), mesh)
                    # The ranks refresh disjoint columns of the batch: the
                    # whole batch's on every rank, one all_reduce of a
                    # zero-filled buffer, then one scatter into the cache
                    # (O(batch) values, not the cache's O(slices)).
                    new_cache_b = sharding.gather_rows(
                        new_cache_b, mesh, batch_indices.numel(),
                        axis=cache.dim() - 1)
                cache.index_copy_(cache.dim() - 1, batch_indices,
                                  new_cache_b)
                optimizer.step(mask)
                losses.append(loss.detach())
            return torch.stack(losses)

        return epoch_fn

    @staticmethod
    def _epoch_permutation(rng: np.random.Generator, n_slices: int,
                           batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Shuffled slice indices padded by wraparound to a whole number of
        batches, plus 0/1 weights marking the wrapped duplicates (weight 0)
        so evaluation passes can average exactly (a copy of the JAX
        package's)."""
        perm = rng.permutation(n_slices)
        n_batches = max(1, int(np.ceil(n_slices / batch_size)))
        padded = np.resize(perm, n_batches * batch_size)
        weights = np.zeros(n_batches * batch_size, dtype=np.float32)
        weights[:min(n_slices, weights.size)] = 1.0
        return padded, weights

    def _on_device(self, array: np.ndarray, dtype) -> Tensor:
        return torch.as_tensor(np.asarray(array), device=self.device).to(
            dtype)

    def _table(self, array: np.ndarray, batch_size: int,
               dtype=torch.int64) -> Tensor:
        return torch.as_tensor(array.reshape(-1, batch_size),
                               device=self.device).to(dtype)

    # -- train loop ------------------------------------------------------------
    def train(self, epoch_callback: EpochCallback = default_epoch_callback
              ) -> Tuple[float, float, Any]:
        """Runs training with early stopping; returns (final train loss,
        best valid loss, best parameters). The monitored metric is the
        validation prediction loss of the per-epoch evaluation (reference
        ``experiment.py:647-657``), or the training objective on the
        validation slices with ``selection_metric="objective"``."""
        config = self.config
        optimizer, state = self.setup_training()
        assert self.data_manager is not None
        ckpt_path = file_utils.checkpoint_path(config.storage,
                                               config.run_name)
        batch_size = int(config.optimizer_config.batch_size.value)
        epoch_fn, eval_epoch_fn = self._build_train_epoch(
            optimizer, batch_size)
        # Epoch-warm solver caching: off under dynamic data updates (the
        # slice set, and with it the cache's indexing, changes).
        warm = None if config.data_config.update_dynamically else \
            self.warm_loss_callback()
        if warm is not None:
            seed_epoch_fn = self._build_warm_train_epoch(
                optimizer, batch_size, seed=True)
            warm_epoch_fn = self._build_warm_train_epoch(
                optimizer, batch_size, seed=False)
        rng = np.random.default_rng(713 + state.epoch)

        params = state.current_params
        dtype = self._params_dtype(params)
        train_set, valid_set, _ = self.data_manager.get_trajectory_sets()
        # The manager assigns trajectories lazily on first scan; record the
        # realized split so resume restores the identical partition.
        state.split_indices = self.data_manager.trajectory_set_indices()
        train_past = self._on_device(train_set.slices_past, dtype)
        train_future = self._on_device(train_set.slices_future, dtype)
        valid_past = self._on_device(valid_set.slices_past, dtype)
        valid_future = self._on_device(valid_set.slices_future, dtype)

        if warm is not None:
            # The cache is never checkpointed: every process run seeds it
            # with one full-budget epoch, and again every
            # ``warm_seed_period`` epochs.
            _, init_cache = warm
            force_cache = init_cache(train_set.n_slices, dtype, self.device)
            epochs_since_seed: Optional[int] = None

        if state.finished_training:
            # A finished checkpoint only short-circuits when its budget is
            # exhausted: a larger epoch budget continues training.
            exhausted = (state.epoch > config.optimizer_config.epochs or
                         state.epochs_since_best >=
                         config.optimizer_config.patience)
            if exhausted:
                return 0.0, state.best_valid_loss, state.best_params
            state.finished_training = False

        # Pre-update loss report (reference experiment.py:594-611).
        perm, weights = self._epoch_permutation(
            rng, train_set.n_slices, batch_size)
        train_loss = float(eval_epoch_fn(
            params, train_past, train_future, self._table(perm, batch_size),
            self._table(weights, batch_size, dtype)))
        select_objective = config.selection_metric == "objective"
        if state.epoch == 1:
            valid_loss = self._epoch_training_objective_on_valid(
                eval_epoch_fn, params, valid_set, valid_past, valid_future,
                rng, batch_size)
            eval_valid_loss = self.per_epoch_evaluation(
                0, params, train_loss, 0.0, valid_loss)
            state.best_valid_loss = valid_loss if (
                select_objective or eval_valid_loss is None) else \
                eval_valid_loss
            epoch_callback(0, params, train_loss, state.best_valid_loss)

        patience = config.optimizer_config.patience
        carried_valid_loss = state.best_valid_loss
        # The last finite state, for the rollback on divergence.
        last_params = snapshot(params)
        last_optimizer_state = optimizer.state_dict()
        try:
            while state.epoch <= config.optimizer_config.epochs:
                if config.data_config.update_dynamically:
                    train_set, valid_set, _ = \
                        self.data_manager.get_trajectory_sets()
                    train_past = self._on_device(train_set.slices_past,
                                                 dtype)
                    train_future = self._on_device(
                        train_set.slices_future, dtype)
                    valid_past = self._on_device(valid_set.slices_past,
                                                 dtype)
                    valid_future = self._on_device(
                        valid_set.slices_future, dtype)
                    state.split_indices = \
                        self.data_manager.trajectory_set_indices()

                start = time.time()
                perm, _ = self._epoch_permutation(
                    rng, train_set.n_slices, batch_size)
                batches = self._table(perm, batch_size)
                if warm is not None:
                    seed_period = config.warm_seed_period
                    reseed = (epochs_since_seed is None or
                              (seed_period > 0 and
                               epochs_since_seed >= seed_period))
                    fn = seed_epoch_fn if reseed else warm_epoch_fn
                    losses = fn(params, optimizer, force_cache, train_past,
                                train_future, batches)
                    epochs_since_seed = 0 if reseed else \
                        epochs_since_seed + 1
                else:
                    losses = epoch_fn(params, optimizer, train_past,
                                      train_future, batches)
                train_loss = float(torch.mean(losses))
                training_duration = time.time() - start

                # Solver-failure masking zeroes bad samples' losses, so
                # non-finite parameters are the reliable sign that
                # training has blown up.
                finite = bool(torch.stack([
                    torch.isfinite(leaf).all()
                    for leaf in params.parameters()]).all())
                if not finite:
                    # Roll back to the last finite state so that the
                    # checkpoint keeps something usable.
                    with torch.no_grad():
                        for leaf, good in zip(params.parameters(),
                                              last_params.parameters()):
                            leaf.copy_(good)
                    optimizer.load_state_dict(last_optimizer_state)
                    raise RuntimeError(
                        f"non-finite parameters after epoch "
                        f"{state.epoch}: training diverged (last train "
                        f"loss {train_loss}); checkpoint preserves the "
                        f"last finite state")

                objective_valid_loss = \
                    self._epoch_training_objective_on_valid(
                        eval_epoch_fn, params, valid_set, valid_past,
                        valid_future, rng, batch_size)
                # A full evaluation on the final budgeted epoch, so that the
                # returned best_valid reflects the trained model.
                final_epoch = state.epoch == config.optimizer_config.epochs
                eval_valid_loss = self.per_epoch_evaluation(
                    state.epoch, params, train_loss, training_duration,
                    objective_valid_loss, force=final_epoch)
                if select_objective or \
                        self.config.full_evaluation_samples <= 0:
                    carried_valid_loss = objective_valid_loss
                elif eval_valid_loss is not None:
                    carried_valid_loss = eval_valid_loss
                valid_loss = carried_valid_loss

                if valid_loss < state.best_valid_loss:
                    state.best_valid_loss = valid_loss
                    state.best_params = snapshot(params)
                    state.epochs_since_best = 0
                else:
                    state.epochs_since_best += 1

                if state.epochs_since_best >= patience:
                    break

                epoch_callback(state.epoch, params, train_loss,
                               state.best_valid_loss)
                last_params = snapshot(params)
                last_optimizer_state = optimizer.state_dict()
                state.epoch += 1

            state.finished_training = True
        finally:
            state.current_params = params
            state.optimizer_state = optimizer.state_dict()
            if self.writer:
                save_checkpoint(ckpt_path, state)

        return train_loss, state.best_valid_loss, state.best_params

    def _epoch_training_objective_on_valid(self, eval_epoch_fn, params,
                                           valid_set: TrajectorySet,
                                           valid_past, valid_future, rng,
                                           batch_size: int) -> float:
        """Training objective on the validation slices (logged as
        ``valid_loss``)."""
        if valid_set.n_slices == 0:
            return 0.0
        perm, weights = self._epoch_permutation(
            rng, valid_set.n_slices, batch_size)
        return float(eval_epoch_fn(
            params, valid_past, valid_future, self._table(perm, batch_size),
            self._table(weights, batch_size, valid_past.dtype)))

    # -- per-epoch evaluation ---------------------------------------------------
    def per_epoch_evaluation(self, epoch: int, params: Any,
                             train_loss: float, training_duration: float,
                             objective_valid_loss: float,
                             force: bool = False) -> Optional[float]:
        """Evaluates and logs training progress at the end of an epoch
        (reference ``experiment.py:422-488``): every
        ``full_evaluation_period`` epochs (or with ``force``) the first
        ``full_evaluation_samples`` train and valid trajectories. Returns
        the validation prediction-loss mean when the evaluation ran, else
        ``None``."""
        assert self.data_manager is not None
        start_eval = time.time()
        statistics: Dict = {}
        period = max(1, self.config.full_evaluation_period)
        if self.config.full_evaluation_samples > 0 and \
                (force or (epoch % period) == 0):
            train_set, valid_set, _ = self.data_manager.get_trajectory_sets()
            n_samples = self.config.full_evaluation_samples
            eval_sets = {}
            for set_name, full_set in ((TRAIN_SET, train_set),
                                       (VALID_SET, valid_set)):
                sampled = self.data_manager.make_sampled_set(
                    full_set, n_samples)
                if sampled.n_slices:
                    eval_sets[set_name] = sampled
            if eval_sets:
                statistics = self.evaluate_systems_on_sets(
                    {LEARNED_SYSTEM_NAME: (self.learned_system, params)},
                    eval_sets)

        valid_loss_key = \
            f"{VALID_SET}_{LEARNED_SYSTEM_NAME}_{LOSS_NAME}_{AVERAGE_TAG}"
        eval_valid_loss = statistics.get(valid_loss_key)

        statistics[f"{TRAIN_SET}_{LEARNED_SYSTEM_NAME}_{LOSS_NAME}_"
                   f"{AVERAGE_TAG}"] = train_loss
        statistics[TRAINING_DURATION] = training_duration
        statistics[EVALUATION_DURATION] = time.time() - start_eval
        self._write_epoch_log(epoch, params, statistics,
                              objective_valid_loss)
        return float(eval_valid_loss) if eval_valid_loss is not None \
            else None

    def _write_epoch_log(self, epoch: int, params, statistics: Dict,
                         objective_valid_loss: float) -> None:
        """Logs per-epoch scalars plus the learned system's summary and
        the comparison media (reference ``write_to_wandb``,
        ``experiment.py:380-420``)."""
        start_log = time.time()
        scalars: Dict[str, float] = {}
        aux_names = tuple(self.space.auxiliary_comparisons())
        for stats_set in TRAIN_TIME_SETS:
            for variable in EVALUATION_VARIABLES + aux_names:
                key = f"{stats_set}_{LEARNED_SYSTEM_NAME}_{variable}_" \
                      f"{AVERAGE_TAG}"
                if key in statistics:
                    scalars[f"{stats_set}_{variable}"] = float(
                        statistics[key])
        scalars[f"{TRAIN_SET}_{LOSS_NAME}"] = float(statistics[
            f"{TRAIN_SET}_{LEARNED_SYSTEM_NAME}_{LOSS_NAME}_{AVERAGE_TAG}"])
        scalars[f"{VALID_SET}_{LOSS_NAME}"] = objective_valid_loss
        for duration in (TRAINING_DURATION, EVALUATION_DURATION):
            scalars[duration] = float(statistics[duration])

        assert self.learned_system is not None
        summary = self.learned_system.summary(params, scalars)
        scalars.update(summary.scalars)
        videos = dict(summary.videos)
        videos.update(
            self.base_and_learned_comparison_summary(statistics, params))
        scalars[LOGGING_DURATION] = time.time() - start_log
        assert self.log_manager is not None
        if self.writer:
            self.log_manager.update(epoch, scalars, videos, summary.meshes)

    # -- evaluation -----------------------------------------------------------
    def _rollout(self, system: System, params: Any, x_hist: Tensor,
                 steps: int) -> Tensor:
        """Predicted states ``(B, steps, n_x)`` from histories ``(B,
        t_history, n_x)``, without gradients: through ``simulate_batch``
        (for a ``MultibodyLearnableSystem`` the fused rollout on K5 from
        ``FUSED_ROLLOUT_MIN_BATCH`` trajectories, the vmapped integrator
        below), or ``simulate`` when the system carries a hidden state.
        With an evaluation mesh (:meth:`evaluation_mesh`) each rank rolls
        out its share of the histories and every rank gets them all
        (``sharding.make_data_parallel_rollout``)."""

        def predict(params, x_hist):
            x_0, carry = system.preprocess_initial_condition(
                params, x_hist, system.initial_carry(x_hist[..., -1, :]))
            if carry.shape[-1] == 0:
                trajectory = system.simulate_batch(params, x_0, steps)
            else:
                trajectory = system.simulate(params, x_0, steps,
                                             carry_0=carry)
            return trajectory[..., 1:, :]

        mesh = self.evaluation_mesh()
        with torch.no_grad():
            if mesh is None:
                return predict(params, x_hist)
            return sharding.make_data_parallel_rollout(predict, mesh)(
                params, x_hist)

    @staticmethod
    def _host_rollouts(system: System, params: Any, x_hist: np.ndarray,
                       steps: int) -> np.ndarray:
        """Predicted states ``(B, steps, n_x)`` of a host-stepped system
        (the MuJoCo oracle): one history at a time, on the host, as the
        JAX package rolls out the reference's ``max_batch_dim = 0``
        systems."""
        rows = []
        for hist in np.asarray(x_hist):
            x_0, carry = system.preprocess_initial_condition(
                params, hist, system.initial_carry(torch.as_tensor(hist[-1])))
            rows.append(np.asarray(system.simulate(
                params, x_0, steps, carry_0=carry))[1:])
        return np.stack(rows)

    def trajectory_predict(self, system: System, params: Any,
                           trajectories, t_skip: int):
        """Rollout predictions for full (variable-length) trajectories:
        padded (in float32, as the JAX package pads) to the longest, one
        batched rollout; per-trajectory (prediction, target, mask) numpy
        arrays."""
        t_begin = t_skip + 1
        max_T = max(t.shape[0] for t in trajectories)
        horizon = max_T - t_begin
        n_x = trajectories[0].shape[-1]

        padded = np.zeros((len(trajectories), max_T, n_x), dtype=np.float32)
        lengths = np.zeros((len(trajectories),), dtype=np.int64)
        for i, trajectory in enumerate(trajectories):
            T = trajectory.shape[0]
            padded[i, :T] = trajectory
            padded[i, T:] = trajectory[-1]  # repeat last state (masked out)
            lengths[i] = T

        if system.host_stepped:
            predictions = self._host_rollouts(system, params,
                                              padded[:, :t_begin], horizon)
        else:
            x_hist = self._on_device(padded[:, :t_begin],
                                     self._params_dtype(params))
            predictions = self._rollout(system, params, x_hist,
                                        horizon).cpu().numpy()
        targets = padded[:, t_begin:]
        masks = (np.arange(horizon)[None, :] <
                 (lengths - t_begin)[:, None])
        return predictions, targets, masks

    def _trajectory_metrics(self, system: System, predictions: np.ndarray,
                            targets: np.ndarray,
                            masks: np.ndarray) -> Dict[str, np.ndarray]:
        """Masked per-trajectory metrics: trajectory MSE and every
        pointwise auxiliary comparison, as masked means over valid
        steps."""
        space = system.space
        pred = torch.as_tensor(predictions, device=self.device)
        target = torch.as_tensor(targets, device=self.device).to(pred.dtype)
        m = torch.as_tensor(masks, device=self.device).to(pred.dtype)
        counts = torch.clamp(torch.sum(m, dim=1), min=1.0)

        def masked_mean(per_step):
            return torch.sum(per_step * m, dim=1) / counts

        with torch.no_grad():
            out = {TRAJECTORY_ERROR_NAME: masked_mean(
                space.state_square_error(pred, target))}
            for name, fn in space.auxiliary_pointwise_comparisons().items():
                out[name] = masked_mean(fn(pred, target))
        return {name: value.cpu().numpy() for name, value in out.items()}

    def _slice_losses(self, system: System, params, past: Tensor,
                      future: Tensor) -> np.ndarray:
        """Per-slice prediction losses in chunks of at most
        ``EVALUATION_SLICE_CHUNK`` rollouts (padded, as in the JAX
        package, to whole chunks of a power of two), without
        gradients. A host-stepped system rolls out each slice on the host
        (the JAX package's ``_host_slice_losses``)."""
        if system.host_stepped:
            x_predicted = torch.as_tensor(self._host_rollouts(
                system, params, past.cpu().numpy(), future.shape[-2]))
            return self._velocity_loss(
                system.space, x_predicted,
                future.cpu().to(x_predicted.dtype)).numpy()
        n = past.shape[0]
        chunk = min(EVALUATION_SLICE_CHUNK,
                    1 << max(0, (n - 1)).bit_length())
        pad = (-n) % chunk
        if pad:
            past = torch.cat([past, past[-1:].expand(pad, *past.shape[1:])])
            future = torch.cat([future,
                                future[-1:].expand(pad, *future.shape[1:])])
        losses = []
        for start in range(0, n + pad, chunk):
            x_future = future[start:start + chunk]
            x_predicted = self._rollout(system, params,
                                        past[start:start + chunk],
                                        x_future.shape[-2])
            losses.append(self._velocity_loss(system.space, x_predicted,
                                              x_future))
        return torch.cat(losses)[:n].cpu().numpy()

    def evaluate_systems_on_sets(self, systems: Dict[str, Tuple[System,
                                                                Any]],
                                 sets: Dict[str, TrajectorySet]) -> Dict:
        """The statistics dictionary (reference ``experiment.py:685-796``):
        per-slice losses, velocity norms, trajectory MSE, auxiliary
        comparisons, sample trajectories and ``_mean`` summaries. Each
        system's rollouts and slice losses run once over all sets together
        (every trajectory's result is its own), then split by set."""
        stats: Dict = {}
        space = self.space
        t_skip = self.config.data_config.slice_config.t_skip
        sets = {name: trajectory_set
                for name, trajectory_set in sets.items()
                if trajectory_set.n_slices}
        if not sets:
            return stats

        pasts, futures = {}, {}
        for set_name, trajectory_set in sets.items():
            past = torch.as_tensor(trajectory_set.slices_past,
                                   device=self.device)
            future = torch.as_tensor(trajectory_set.slices_future,
                                     device=self.device)
            pasts[set_name], futures[set_name] = past, future
            v_plus = space.v(future[:, 0, :])
            v_minus = space.v(past[:, -1, :])
            stats[f"{set_name}_{DELTA_VELOCITY_SIZE}"] = \
                space.velocity_square_error(v_plus, v_minus).cpu().numpy()
            stats[f"{set_name}_{PREDICTED_VELOCITY_SIZE}"] = \
                space.velocity_square_error(
                    v_plus, torch.zeros_like(v_plus)).cpu().numpy()
        slice_ends = np.cumsum([s.n_slices for s in sets.values()])[:-1]
        trajectory_ends = np.cumsum(
            [len(s.trajectories) for s in sets.values()])[:-1]
        all_past = torch.cat(list(pasts.values()))
        all_future = torch.cat(list(futures.values()))
        trajectories = [t for s in sets.values() for t in s.trajectories]

        for system_name, (system, params) in systems.items():
            dtype = self._params_dtype(params)
            losses = self._slice_losses(system, params, all_past.to(dtype),
                                        all_future.to(dtype))
            predictions, targets, masks = self.trajectory_predict(
                system, params, trajectories, t_skip)
            metrics = self._trajectory_metrics(system, predictions,
                                               targets, masks)
            split = {name: np.split(values, trajectory_ends)
                     for name, values in metrics.items()}
            set_losses = np.split(losses, slice_ends)
            set_rows = np.split(np.arange(len(trajectories)),
                                trajectory_ends)
            for i, set_name in enumerate(sets):
                stats[f"{set_name}_{system_name}_{LOSS_NAME}"] = \
                    set_losses[i]
                for name in metrics:
                    stats[f"{set_name}_{system_name}_{name}"] = \
                        split[name][i]
                if system_name == LEARNED_SYSTEM_NAME:
                    rows = set_rows[i][:MAX_SAVED_TRAJECTORIES]
                    stats[f"{set_name}_{system_name}_{TARGET_NAME}"] = [
                        targets[r][masks[r]] for r in rows]
                    stats[f"{set_name}_{system_name}_{PREDICTION_NAME}"] = [
                        predictions[r][masks[r]] for r in rows]

        stats.update(summarize_statistics(stats))
        return stats

    def base_and_learned_comparison_summary(self, statistics: Dict,
                                            best_params: Any) -> Dict:
        """Optional rich-media comparison (overlay videos) built from the
        evaluation statistics; a videos dict. Subclasses override."""
        del statistics, best_params
        return {}

    def _evaluation(self, best_params: Any) -> Dict:
        """Final oracle-vs-model evaluation on all sets, saved to disk
        (reference ``experiment.py:798-824``)."""
        assert self.data_manager is not None
        sets = dict(zip(ALL_SETS, self.data_manager.get_trajectory_sets()))
        oracle_system, oracle_params = self.get_oracle_system()
        systems = {
            ORACLE_SYSTEM_NAME: (oracle_system, oracle_params),
            LEARNED_SYSTEM_NAME: (self.learned_system, best_params),
        }
        evaluation = self.evaluate_systems_on_sets(systems, sets)
        if not self.writer:
            return evaluation
        file_utils.save_evaluation(self.config.storage,
                                   self.config.run_name, evaluation)
        videos = self.base_and_learned_comparison_summary(
            evaluation, best_params)
        if videos and self.log_manager is not None:
            self.log_manager.update(-1, {}, videos, {})
        return evaluation

    def generate_results(self, epoch_callback: EpochCallback =
                         default_epoch_callback) -> Tuple[Any, Dict]:
        """Trains (or resumes) and evaluates; returns (best parameters,
        statistics) (reference ``experiment.py:826-851``)."""
        _, _, best_params = self.train(epoch_callback)
        try:
            statistics = file_utils.load_evaluation(
                self.config.storage, self.config.run_name)
        except FileNotFoundError:
            statistics = self._evaluation(best_params)
        return best_params, statistics
