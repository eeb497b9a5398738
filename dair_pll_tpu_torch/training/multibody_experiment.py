r"""Multibody system-identification experiments (PyTorch).

Counterpart of ``dair_pll_tpu/training/multibody_experiment.py`` (the
reference's ``drake_experiment.py:23-224`` without Drake): the base
(ground-truth) system is the port's multibody engine at the URDFs' true
parameters, with polygon meshes; the learnable system starts from those
URDFs and optimizes inertia, friction and geometry.

``MultibodyLosses.CONTACTNETS_LOSS`` swaps the training loss to the
ContactNets implicit loss, as the reference does
(``drake_experiment.py:174-175,202-224``): the loss takes
``x = x_past[..., -1, :]`` and ``x_plus = x_future[..., 0, :]``.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.training.config import (
    SupervisedLearningExperimentConfig, SystemConfig)
from dair_pll_tpu_torch.training.experiment import (
    SupervisedLearningExperiment)
from dair_pll_tpu_torch.urdf import build_multibody_model
from dair_pll_tpu_torch.utils import file_utils


class MultibodyLosses(enum.Enum):
    """Training-loss selection (reference ``drake_experiment.py:30-33``)."""
    PREDICTION_LOSS = 1
    CONTACTNETS_LOSS = 2


@dataclasses.dataclass
class MultibodySystemConfig(SystemConfig):
    """Ground-truth multibody system description (role of the reference's
    ``DrakeSystemConfig``, ``drake_experiment.py:23-27``)."""
    urdfs: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MultibodyLearnableSystemConfig(MultibodySystemConfig):
    """Learnable multibody system description (reference
    ``drake_experiment.py:36-43``); the fields of the JAX package's.

    Attributes:
        loss: the training loss.
        mesh_representation: how mesh collision elements are learned
          (``"deep_support_convex"``: an ICNN support function).
        fix_inertial_scale: pin body 0's overall inertial scale, which the
          ContactNets loss cannot observe.
        fix_environment_friction: pin the friction of plane geometries
          (only the pairwise combined coefficient is physical).
        contactnets_multistep: sum the ContactNets loss over the whole
          prediction window, each step's state from the model's own
          rollout (recomputed in the backward pass,
          ``torch.utils.checkpoint``).
        loss_dtype: dtype the ContactNets loss and its backward pass run
          in, e.g. ``"float64"``: states and parameters are cast at the
          loss boundary, the gradient comes back in the parameters' dtype.
        loss_solver_budget: ``(ipm, newton)`` of the cold loss solves.
        force_fused_loss: ``True`` forces the fused loss path (the loss
          kernels K1 and K2 on the card) at any batch size, ``False`` the
          vmapped path; ``None`` the fused path from
          ``FUSED_LOSS_MIN_BATCH`` transitions.
        use_warm_loss: epoch-warm ContactNets solves (the cache of each
          training slice's impulse, warm epochs on K3 and K2); ``None`` is
          on when the system runs on the card and the configuration
          supports it, off on the CPU (the JAX package: off on its CPU
          backend); ``True`` raises if unsupported.
        warm_solver_budget: ``(ipm, newton)`` of warm epochs; ``None`` is
          ``DEFAULT_LOSS_WARM_BUDGET``.
    """
    loss: MultibodyLosses = MultibodyLosses.PREDICTION_LOSS
    mesh_representation: str = "deep_support_convex"
    fix_inertial_scale: bool = True
    fix_environment_friction: bool = True
    contactnets_multistep: bool = False
    loss_dtype: Optional[str] = None
    loss_solver_budget: Optional[Tuple[int, int]] = None
    force_fused_loss: Optional[bool] = None
    use_warm_loss: Optional[bool] = None
    warm_solver_budget: Optional[Tuple[int, int]] = None


class MultibodyLearnableExperiment(SupervisedLearningExperiment):
    """System identification of a contact-rich multibody system (role of
    the reference's ``DrakeMultibodyLearnableExperiment``,
    ``drake_experiment.py:164-224``)."""

    def __init__(self, config: SupervisedLearningExperimentConfig,
                 device=None, dtype=torch.float32) -> None:
        super().__init__(config, device, dtype)
        self._base_cache: Optional[Tuple[MultibodyLearnableSystem, Any]] = \
            None
        self._video_call_count = 0

    def get_base_system(self) -> Tuple[MultibodyLearnableSystem, Any]:
        """Ground-truth system at the base URDFs' parameters; mesh
        collision elements use their exact vertex polygons."""
        if self._base_cache is None:
            base_config = self.config.base_config
            assert isinstance(base_config, MultibodySystemConfig)
            model = build_multibody_model(
                base_config.urdfs, mesh_representation="polygon")
            system = MultibodyLearnableSystem(
                model, self.config.data_config.dt, device=self.device)
            self._base_cache = (system, system.initial_params(self.dtype))
        return self._base_cache

    def get_learned_system(self) -> Tuple[MultibodyLearnableSystem, Any]:
        """Learnable system initialized from its URDFs, with the loss
        solves' budget from ``loss_solver_budget``."""
        learnable_config = self.config.learnable_config
        assert isinstance(learnable_config, MultibodyLearnableSystemConfig)
        model = build_multibody_model(
            learnable_config.urdfs,
            mesh_representation=learnable_config.mesh_representation)
        solver_kwargs = {}
        if learnable_config.loss_solver_budget is not None:
            ipm, newton = learnable_config.loss_solver_budget
            solver_kwargs = {"ipm_iterations": int(ipm),
                             "newton_iterations": int(newton)}
        system = MultibodyLearnableSystem(
            model, self.config.data_config.dt, device=self.device,
            **solver_kwargs)
        return system, system.initial_params(self.dtype)

    def loss_callback(self):
        learnable_config = self.config.learnable_config
        assert isinstance(learnable_config, MultibodyLearnableSystemConfig)
        if learnable_config.loss == MultibodyLosses.PREDICTION_LOSS:
            return super().loss_callback()

        system = self.learned_system
        assert isinstance(system, MultibodyLearnableSystem)
        n_u = system.model.n_u
        multistep = learnable_config.contactnets_multistep
        use_fused = learnable_config.force_fused_loss
        loss_dtype = None if learnable_config.loss_dtype is None else \
            getattr(torch, learnable_config.loss_dtype)

        def rollout_step(params, x):
            # Recomputed in the backward pass (JAX's jax.checkpoint).
            return torch.utils.checkpoint.checkpoint(
                system.sim_step, params, x, use_reentrant=False)

        def contactnets_loss(params, x_past, x_future):
            """The transition endpoints as in reference
            ``drake_experiment.py:202-224``; with ``contactnets_multistep``
            the mean over the prediction window, each step's state from
            the model's own rollout."""
            if loss_dtype is not None:
                # The cast is differentiable: gradients accumulate in
                # loss_dtype and return in the parameters' dtype.
                params = params.map(lambda leaf: leaf.to(loss_dtype))
                x_past = x_past.to(loss_dtype)
                x_future = x_future.to(loss_dtype)
            x = x_past[..., -1, :]
            u = x.new_zeros(x.shape[:-1] + (n_u,))
            t_window = x_future.shape[-2] if multistep else 1
            total = system.contactnets_loss_batch(
                params, x, u, x_future[..., 0, :], use_fused=use_fused)
            for t in range(1, t_window):
                x = rollout_step(params, x)
                total = total + system.contactnets_loss_batch(
                    params, x, u, x_future[..., t, :], use_fused=use_fused)
            return total / t_window

        return contactnets_loss

    def warm_loss_callback(self):
        """Epoch-warm ContactNets solves (see
        ``MultibodyLearnableSystemConfig.use_warm_loss``): the
        single-step ContactNets loss on a model of the fused path; the
        cache is the ``(3, k, n_slices)`` stacked contact impulse. Unlike
        the JAX package's, it takes a ``loss_dtype`` (the port's loss
        kernels run in float64 too): states and parameters are cast at the
        loss boundary and the cache is kept in that dtype."""
        learnable_config = self.config.learnable_config
        assert isinstance(learnable_config,
                          MultibodyLearnableSystemConfig)
        use = learnable_config.use_warm_loss
        if use is False:
            return None
        unsupported = None
        if learnable_config.loss != MultibodyLosses.CONTACTNETS_LOSS:
            unsupported = "requires the ContactNets loss"
        elif learnable_config.contactnets_multistep:
            unsupported = "single-step ContactNets only"
        system = self.learned_system
        assert isinstance(system, MultibodyLearnableSystem)
        if unsupported is None and not system.supports_fused_loss():
            unsupported = "model lacks fused SoA loss support"
        if use is None:
            # Auto: on the card, off on the CPU.
            if unsupported is not None or system.device.type == "cpu":
                return None
        elif unsupported is not None:
            raise ValueError(f"use_warm_loss: {unsupported}")

        n_u = system.model.n_u
        k = system.model.n_contacts
        warm_budget = learnable_config.warm_solver_budget
        seed_budget = (system.ipm_iterations, system.newton_iterations)
        loss_dtype = None if learnable_config.loss_dtype is None else \
            getattr(torch, learnable_config.loss_dtype)

        def make_warm_fn(seed: bool):
            budget = seed_budget if seed else warm_budget

            def warm_fn(params, x_past, x_future, cache):
                if loss_dtype is not None:
                    params = params.map(lambda leaf: leaf.to(loss_dtype))
                    x_past = x_past.to(loss_dtype)
                    x_future = x_future.to(loss_dtype)
                x = x_past[..., -1, :]
                u = x.new_zeros(x.shape[:-1] + (n_u,))
                return system.contactnets_loss_batch_warm(
                    params, x, u, x_future[..., 0, :], cache,
                    budget=budget)

            return warm_fn

        def init_cache(n_slices: int, dtype, device):
            return torch.zeros((3, k, n_slices), dtype=loss_dtype or dtype,
                               device=device)

        return make_warm_fn, init_cache

    def base_and_learned_comparison_summary(self, statistics: Dict,
                                            best_params: Any) -> Dict:
        """Overlay videos of the first saved trajectory pair of each set in
        the statistics (role of reference ``drake_experiment.py:119-161``),
        rendered on the host by ``vis_utils`` every ``video_period``-th
        evaluation that carries samples. With
        ``config.update_geometry_in_videos`` the geometry is the learned
        one, else the initial (URDF) one. Rendering needs matplotlib; a
        machine without it logs no videos. Beside each video, as in the
        JAX package, an interactive three.js page of the same pair
        (``interactive_vis.export_interactive_html``) goes under the run's
        ``interactive/``; it needs no matplotlib, so it is written on a
        machine without it too."""
        assert isinstance(self.learned_system, MultibodyLearnableSystem)
        config = self.config
        has_samples = any(
            statistics.get(f"{set_name}_model_target_sample")
            for set_name in ("train", "valid", "test"))
        if not has_samples or config.video_period <= 0:
            return {}
        count = self._video_call_count
        self._video_call_count += 1
        if count % config.video_period != 0:
            return {}
        try:
            import matplotlib  # noqa: F401
            has_matplotlib = True
        except ImportError:
            has_matplotlib = False
        from dair_pll_tpu_torch.interactive_vis import export_interactive_html
        from dair_pll_tpu_torch.vis_utils import visualize_trajectory
        if config.update_geometry_in_videos:
            video_params = best_params
        else:
            video_params = self.learned_system.initial_params(self.dtype)
        videos = {}
        for set_name in ("train", "valid", "test"):
            target_key = f"{set_name}_model_target_sample"
            prediction_key = f"{set_name}_model_prediction_sample"
            if target_key not in statistics or not statistics[target_key]:
                continue
            if has_matplotlib:
                video, fps = visualize_trajectory(
                    self.learned_system.model, video_params,
                    statistics[target_key][0],
                    statistics[prediction_key][0],
                    self.config.data_config.dt,
                    max_frames=config.video_max_frames,
                    height=config.video_height, width=config.video_width)
                videos[f"{set_name}_trajectory_overlay"] = (video, fps)
            if self.writer:
                export_interactive_html(
                    self.learned_system.model, video_params,
                    statistics[prediction_key][0],
                    statistics[target_key][0], self.config.data_config.dt,
                    os.path.join(file_utils.run_dir(config.storage,
                                                    config.run_name),
                                 "interactive", f"{set_name}_overlay.html"),
                    title=f"{config.run_name} {set_name}")
        return videos

    def parameter_update_mask(self, params: Any) -> Optional[Any]:
        """Zeroes the gradients of unidentifiable parameter directions:
        body 0's inertial-scale coordinate ``theta[0, 0]`` with
        ``fix_inertial_scale``, and plane friction coefficients with
        ``fix_environment_friction``."""
        learnable_config = self.config.learnable_config
        assert isinstance(learnable_config, MultibodyLearnableSystemConfig)
        if not (learnable_config.fix_inertial_scale or
                learnable_config.fix_environment_friction):
            return None
        mask = params.map(lambda leaf: torch.ones_like(leaf.detach()))
        if learnable_config.fix_inertial_scale:
            mask.theta[0, 0] = 0.0
        if learnable_config.fix_environment_friction:
            assert isinstance(self.learned_system, MultibodyLearnableSystem)
            for g, spec in enumerate(self.learned_system.model.geometries):
                if spec.geom_type == "plane":
                    mask.friction[g] = 0.0
        return mask

    def generate_updated_urdfs(self, params: Any) -> Dict[str, str]:
        """Exports the learned parameters as URDFs (reference
        ``multibody_learnable_system.py:82-102``)."""
        from dair_pll_tpu_torch.urdf_export import (
            represent_multibody_terms_as_urdfs)
        assert isinstance(self.learned_system, MultibodyLearnableSystem)
        output_dir = file_utils.urdf_dir(self.config.storage,
                                         self.config.run_name)
        urdf_strings = represent_multibody_terms_as_urdfs(
            self.learned_system.model, params, output_dir)
        new_urdfs = {}
        for name, urdf_string in urdf_strings.items():
            original = dict(self.learned_system.model.urdf_paths)[name]
            path = os.path.join(output_dir, os.path.basename(original))
            file_utils.save_string(path, urdf_string)
            new_urdfs[name] = path
        return new_urdfs
