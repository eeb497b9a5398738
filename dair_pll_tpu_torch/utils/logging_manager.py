r"""Experiment logging: local JSONL always, Weights & Biases when available.

A copy of ``dair_pll_tpu/utils/logging_manager.py`` (it imports no JAX);
meshes are written by the port's ``mesh_extraction.mesh_to_obj``.

Rebuild of the reference's ``wandb_manager.py``
(``dair_pll/wandb_manager.py:16-106``): per-epoch scalars,
videos, and meshes, with timestamped run-id minting and resume support.
Since external tracking may be unavailable (air-gapped TPU pods), every
run always logs scalars to ``runs/<run>/log.jsonl``; wandb is attached
opportunistically if the package is importable and enabled.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from dair_pll_tpu_torch.utils import file_utils


class ExperimentLogManager:
    """Mints a run id, logs scalars/videos/meshes per epoch."""

    def __init__(self, storage: str, run_name: str,
                 use_wandb: bool = False,
                 wandb_project: Optional[str] = None,
                 resume_id: Optional[str] = None) -> None:
        self.storage = storage
        self.run_name = run_name
        self._log_path = file_utils.log_path(storage, run_name)
        self._wandb = None
        if resume_id is not None:
            self.run_id = resume_id
        else:
            self.run_id = f"{run_name}_{int(time.time() * 1e3)}"
        if use_wandb:
            try:
                import wandb  # type: ignore
                self._wandb = wandb.init(
                    project=wandb_project, id=self.run_id,
                    resume="allow", name=run_name)
            except Exception:
                self._wandb = None

    def update(self, epoch: int, scalars: Dict[str, float],
               videos: Optional[Dict[str, Tuple[np.ndarray, int]]] = None,
               meshes: Optional[Dict] = None) -> None:
        """Logs one epoch of scalars (JSONL + wandb) and rich media
        (wandb only when available; meshes are also saved as obj files)."""
        record = {"epoch": epoch}
        record.update({k: float(v) for k, v in scalars.items()
                       if np.isscalar(v) or np.ndim(v) == 0})
        with open(self._log_path, "a", encoding="utf-8") as handle:
            handle.write(json.dumps(record) + "\n")

        if meshes:
            from dair_pll_tpu_torch.mesh_extraction import mesh_to_obj
            mesh_dir = os.path.join(
                file_utils.run_dir(self.storage, self.run_name), "meshes")
            os.makedirs(mesh_dir, exist_ok=True)
            for name, mesh in meshes.items():
                file_utils.save_string(
                    os.path.join(mesh_dir, f"{name}_{epoch}.obj"),
                    mesh_to_obj(mesh))

        if videos:
            video_dir = os.path.join(
                file_utils.run_dir(self.storage, self.run_name), "videos")
            os.makedirs(video_dir, exist_ok=True)
            for name, (video, fps) in videos.items():
                np.savez_compressed(
                    os.path.join(video_dir, f"{name}_{epoch}.npz"),
                    video=video, fps=fps)

        if self._wandb is not None:
            import wandb  # type: ignore
            payload: Dict = dict(record)
            for name, (video, fps) in (videos or {}).items():
                payload[name] = wandb.Video(video[0], fps=fps)
            for name, mesh in (meshes or {}).items():
                vertices = np.asarray(mesh.vertices)
                payload[name] = wandb.Object3D(vertices)
            self._wandb.log(payload, step=epoch)


# Backwards-compatible alias mirroring the reference class name.
WeightsAndBiasesManager = ExperimentLogManager
