r"""Trajectory visualization: target-vs-prediction overlay videos
(PyTorch port of ``dair_pll_tpu/vis_utils.py``).

Rebuild of the reference's ``vis_utils.py``
(``dair_pll/vis_utils.py:35-189``), which replays state
pairs through a doubled Drake scene (base geometry red, learned blue) and
records with Drake's ``VideoWriter``. Drake is not a dependency here, so
frames are rendered host-side with matplotlib's 3D axes, imported inside
the render function — this is a logging-path utility, not a training-path
component, and a machine without matplotlib turns videos off
(``video_period=0``).

Output matches the reference contract: a ``(1, T, 3, H, W)`` uint8 array
plus frame rate (``vis_utils.py:118-189``), ready for experiment loggers.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

import torch

from dair_pll_tpu_torch.ops import quaternion

VIDEO_HEIGHT = 480
VIDEO_WIDTH = 640
BASE_COLOR = (0.8, 0.2, 0.2, 0.55)     # target: red (reference :66)
LEARNED_COLOR = (0.2, 0.2, 0.8, 0.55)  # prediction: blue


def _box_faces(half_lengths: np.ndarray) -> np.ndarray:
    """12 triangles (as vertex triplets) of an axis-aligned box."""
    h = np.asarray(half_lengths)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)]) * h
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    return np.stack([corners[list(quad)] for quad in quads])


def _transform(vertices: np.ndarray, quat: np.ndarray,
               pos: np.ndarray) -> np.ndarray:
    R = quaternion.to_rotation_matrix(
        torch.as_tensor(np.asarray(quat, dtype=np.float64))).numpy()
    return vertices @ R.T + pos


def render_state_pair_frames(
        target: np.ndarray, prediction: np.ndarray,
        geometry_faces: Dict[int, np.ndarray],
        body_q_offsets: Dict[int, int],
        fps: int, height: int = VIDEO_HEIGHT,
        width: int = VIDEO_WIDTH) -> Tuple[np.ndarray, int]:
    """Renders overlay frames for target/prediction trajectories.

    Args:
        target: ``(T, n_x)`` ground-truth states.
        prediction: ``(T, n_x)`` predicted states.
        geometry_faces: body index -> ``(F, 4, 3)`` quad faces (body frame).
        body_q_offsets: body index -> configuration offset of the body's
          floating coordinates.
        fps: frame rate to report.

    Returns:
        ``(1, T, 3, H, W)`` uint8 video array and fps (reference
        ``vis_utils.py:118-189`` contract).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    T = target.shape[0]
    frames = []
    fig = plt.figure(figsize=(width / 100, height / 100), dpi=100)
    try:
        for t in range(T):
            fig.clf()
            ax = fig.add_subplot(projection="3d")
            ax.set_xlim(-0.4, 0.4)
            ax.set_ylim(-0.4, 0.4)
            ax.set_zlim(0.0, 0.5)
            ax.set_box_aspect((1, 1, 0.7))
            # ground plane
            ax.plot_surface(
                np.array([[-0.4, 0.4], [-0.4, 0.4]]),
                np.array([[-0.4, -0.4], [0.4, 0.4]]),
                np.zeros((2, 2)), color=(0.7, 0.7, 0.7, 0.3))
            for states, color in ((target[t], BASE_COLOR),
                                  (prediction[t], LEARNED_COLOR)):
                for body, faces in geometry_faces.items():
                    offset = body_q_offsets[body]
                    quat = states[offset:offset + 4]
                    pos = states[offset + 4:offset + 7]
                    moved = np.stack([
                        _transform(f, quat, pos) for f in faces])
                    ax.add_collection3d(Poly3DCollection(
                        list(moved), facecolor=color[:3], alpha=color[3],
                        edgecolor="k", linewidths=0.3))
            ax.set_axis_off()
            fig.canvas.draw()
            buffer = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            frames.append(buffer.copy())
    finally:
        plt.close(fig)

    video = np.stack(frames)                       # (T, H, W, 3)
    video = np.transpose(video, (0, 3, 1, 2))[None]  # (1, T, 3, H, W)
    return video.astype(np.uint8), fps


def visualize_trajectory(model, params, target: np.ndarray,
                         prediction: np.ndarray, dt: float,
                         max_frames: int = 60,
                         height: int = VIDEO_HEIGHT,
                         width: int = VIDEO_WIDTH
                         ) -> Tuple[np.ndarray, int]:
    """Overlay video of a target/prediction pair for a multibody model.

    Builds box face sets from the model's (learned) geometry; plays the
    role of reference ``visualize_trajectory`` (``vis_utils.py:118-189``).
    """
    geometry_faces = {}
    for geom_index, spec in enumerate(model.geometries):
        if spec.body < 0:
            continue
        if spec.geom_type == "box":
            half = np.abs(params.geometry[geom_index]["half_lengths"]
                          .detach().cpu().double().numpy()).reshape(3)
        else:
            half = np.full(3, 0.05)
        geometry_faces[spec.body] = _box_faces(half)
    body_q_offsets = {body: model.body_q_offset(body)
                      for body in geometry_faces}

    stride = max(1, -(-target.shape[0] // max_frames))  # ceil: <= cap
    fps = max(1, int(round(1.0 / (dt * stride))))
    return render_state_pair_frames(
        np.asarray(target)[::stride], np.asarray(prediction)[::stride],
        geometry_faces, body_q_offsets, fps, height=height, width=width)
