r"""Interactive HTML (three.js) rollout visualization (PyTorch).

Counterpart of ``dair_pll_tpu/interactive_vis.py``: complements the
matplotlib overlay renderer (``vis_utils.py``) with a self-contained
interactive export: one HTML file embedding the predicted and target
trajectories plus the (learned) collision geometry, rendered with
three.js — orbit controls, a time slider, play/pause, and a translucent
overlay of prediction against ground truth. The poses come from the
port's kinematics and quaternions, the polygon and ICNN meshes from its
``mesh_extraction``; the page is the JAX package's.

The file embeds all trajectory/geometry data as JSON; only the three.js
library itself loads from a CDN (the viewer needs a browser anyway).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>dair_pll_tpu_torch rollout: __TITLE__</title>
<style>
  body { margin: 0; font-family: sans-serif; background: #111;
         color: #eee; }
  #bar { position: fixed; bottom: 0; left: 0; right: 0; padding: 10px;
         background: rgba(0,0,0,0.7); display: flex; gap: 10px;
         align-items: center; }
  #time { flex: 1; }
  .swatch { display: inline-block; width: 12px; height: 12px;
            margin-right: 4px; }
</style>
</head>
<body>
<div id="bar">
  <button id="play">&#9654;</button>
  <input type="range" id="time" min="0" max="0" value="0" step="1"/>
  <span id="label"></span>
  <span><span class="swatch" style="background:#4fc3f7"></span>prediction
  <span class="swatch" style="background:#ffb74d"></span>target</span>
</div>
<script type="importmap">
{ "imports": {
  "three": "https://cdn.jsdelivr.net/npm/three@0.160.0/build/three.module.js",
  "three/addons/": "https://cdn.jsdelivr.net/npm/three@0.160.0/examples/jsm/"
} }
</script>
<script type="module">
import * as THREE from 'three';
import { OrbitControls } from 'three/addons/controls/OrbitControls.js';

const DATA = __DATA__;

const scene = new THREE.Scene();
scene.background = new THREE.Color(0x111111);
const camera = new THREE.PerspectiveCamera(
    50, innerWidth / innerHeight, 0.001, 100);
camera.position.set(0.4, -0.4, 0.25);
camera.up.set(0, 0, 1);
const renderer = new THREE.WebGLRenderer({antialias: true});
renderer.setSize(innerWidth, innerHeight);
document.body.appendChild(renderer.domElement);
const controls = new OrbitControls(camera, renderer.domElement);
controls.target.set(0, 0, 0.05);

scene.add(new THREE.AmbientLight(0xffffff, 0.7));
const sun = new THREE.DirectionalLight(0xffffff, 1.2);
sun.position.set(1, -1, 2);
scene.add(sun);
const grid = new THREE.GridHelper(2, 40, 0x444444, 0x2a2a2a);
grid.rotation.x = Math.PI / 2;
scene.add(grid);

function bodyMesh(geom, color) {
  let geometry;
  if (geom.type === 'box') {
    geometry = new THREE.BoxGeometry(
        2 * geom.half_lengths[0], 2 * geom.half_lengths[1],
        2 * geom.half_lengths[2]);
  } else if (geom.type === 'sphere') {
    geometry = new THREE.SphereGeometry(geom.radius, 24, 16);
  } else if (geom.type === 'cylinder') {
    geometry = new THREE.CylinderGeometry(
        geom.radius, geom.radius, 2 * geom.half_length, 24);
    geometry.rotateX(Math.PI / 2);   // three.js cylinders are y-axis
  } else {  // mesh: vertices + faces
    geometry = new THREE.BufferGeometry();
    geometry.setAttribute('position', new THREE.Float32BufferAttribute(
        geom.vertices.flat(), 3));
    geometry.setIndex(geom.faces.flat());
    geometry.computeVertexNormals();
  }
  const material = new THREE.MeshStandardMaterial({
      color: color, transparent: true, opacity: 0.55, roughness: 0.6});
  const mesh = new THREE.Mesh(geometry, material);
  const edges = new THREE.LineSegments(
      new THREE.EdgesGeometry(geometry),
      new THREE.LineBasicMaterial({color: color}));
  const group = new THREE.Group();
  group.add(mesh); group.add(edges);
  const offset = new THREE.Group();
  offset.add(group);
  group.position.fromArray(geom.p_BG);
  group.setRotationFromMatrix(new THREE.Matrix4().setFromMatrix3(
      new THREE.Matrix3().fromArray(geom.R_BG.flat()).transpose()));
  return offset;
}

const sets = [];
for (const [name, color] of [['prediction', 0x4fc3f7],
                             ['target', 0xffb74d]]) {
  const bodies = [];
  for (const body of DATA.bodies) {
    const group = new THREE.Group();
    for (const geom of body.geometries)
      group.add(bodyMesh(geom, color));
    scene.add(group);
    bodies.push(group);
  }
  sets.push({name: name, traj: DATA[name], bodies: bodies});
}

const T = DATA.prediction.length;
const slider = document.getElementById('time');
slider.max = T - 1;
const label = document.getElementById('label');
let playing = true;
document.getElementById('play').onclick = () => { playing = !playing; };
slider.oninput = () => { playing = false; };

function setFrame(t) {
  for (const set of sets) {
    const frame = set.traj[t];
    set.bodies.forEach((group, b) => {
      const pose = frame[b];           // [qw qx qy qz x y z]
      group.quaternion.set(pose[1], pose[2], pose[3], pose[0]);
      group.position.set(pose[4], pose[5], pose[6]);
    });
  }
  label.textContent = 't = ' + (t * DATA.dt).toFixed(3) + ' s';
}

let t = 0, accum = 0, last = performance.now();
function animate(now) {
  requestAnimationFrame(animate);
  if (playing) {
    accum += (now - last) / 1000;
    while (accum > DATA.dt) { accum -= DATA.dt; t = (t + 1) % T; }
    slider.value = t;
  } else { t = parseInt(slider.value); }
  last = now;
  setFrame(t);
  controls.update();
  renderer.render(scene, camera);
}
animate(last);
addEventListener('resize', () => {
  camera.aspect = innerWidth / innerHeight;
  camera.updateProjectionMatrix();
  renderer.setSize(innerWidth, innerHeight);
});
</script>
</body>
</html>
"""


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().double().numpy()
    return np.asarray(value, dtype=np.float64)


def _geometry_payload(model, params) -> List[Dict[str, Any]]:
    """Per-body geometry descriptions with learned parameter values."""
    from dair_pll_tpu_torch.mesh_extraction import extract_mesh
    bodies: List[Dict[str, Any]] = [
        {"geometries": []} for _ in range(model.n_bodies)]
    for index, spec in enumerate(model.geometries):
        if spec.body < 0:
            continue
        gp = params.geometry[index]
        entry: Dict[str, Any] = {
            "R_BG": np.asarray(spec.R_BG).tolist(),
            "p_BG": list(spec.p_BG),
        }
        if spec.geom_type == "box":
            entry["type"] = "box"
            entry["half_lengths"] = np.abs(_numpy(
                gp["half_lengths"])).reshape(-1).tolist()
        elif spec.geom_type == "sphere":
            entry["type"] = "sphere"
            entry["radius"] = float(np.abs(_numpy(gp["radius"])))
        elif spec.geom_type == "cylinder":
            entry["type"] = "cylinder"
            entry["radius"] = float(np.abs(_numpy(gp["radius"])))
            entry["half_length"] = float(np.abs(_numpy(
                gp["half_length"])))
        else:
            # polygon / deep support: extract a renderable mesh.
            if spec.geom_type == "polygon":
                vertices = _numpy(gp["vertices"])

                def support_fn(directions, vertices=vertices):
                    idx = np.argmax(directions @ vertices.T, axis=-1)
                    return vertices[idx]
            else:
                from dair_pll_tpu_torch.ops import icnn
                net = gp["icnn"]
                slope = spec.icnn_negative_slope
                like = net["output_weight"]

                def support_fn(directions, net=net, slope=slope, like=like):
                    d = torch.as_tensor(directions, dtype=torch.float32)
                    with torch.no_grad():
                        points = icnn.icnn_support_points(
                            net, d.to(like.device, like.dtype), slope)
                    return points.cpu().double().numpy()
            mesh = extract_mesh(support_fn)
            entry["type"] = "mesh"
            entry["vertices"] = np.asarray(mesh.vertices).tolist()
            entry["faces"] = np.asarray(mesh.faces).tolist()
        bodies[spec.body]["geometries"].append(entry)
    return bodies


def _poses(model, trajectory) -> List[List[List[float]]]:
    """Per-frame, per-body ``[qw qx qy qz x y z]`` pose rows."""
    from dair_pll_tpu_torch.multibody.kinematics import body_kinematics
    from dair_pll_tpu_torch.ops import quaternion as quat_mod
    q = torch.as_tensor(_numpy(trajectory)[:, :model.n_q])
    with torch.no_grad():
        kin = body_kinematics(model, q)
        quats = quat_mod.from_rotation_matrix(kin.R_WB)
        poses = torch.cat((quats, kin.p_WB), dim=-1).numpy()
    return [np.round(frame, 5).tolist() for frame in poses]


def export_interactive_html(model, params, prediction,
                            target: Optional[Any], dt: float,
                            path: str, title: str = "rollout") -> str:
    """Writes a self-contained interactive rollout viewer.

    Args:
        model: :class:`MultibodyModel`.
        params: :class:`MultibodyParams` (learned geometry is rendered).
        prediction: ``(T, n_x)`` predicted trajectory (numpy or a tensor).
        target: optional ``(T, n_x)`` ground-truth trajectory.
        dt: time step for playback speed.
        path: output ``.html`` path.

    Returns:
        The output path.
    """
    if target is None:
        target = prediction
    data = {
        "dt": float(dt),
        "bodies": _geometry_payload(model, params),
        "prediction": _poses(model, prediction),
        "target": _poses(model, target),
    }
    html = _TEMPLATE.replace("__TITLE__", title).replace(
        "__DATA__", json.dumps(data))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(html)
    return path
