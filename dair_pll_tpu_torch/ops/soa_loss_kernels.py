r"""Hand-written CUDA kernels of the ContactNets loss and their autograd.

Counterpart of ``dair_pll_tpu/ops/soa_loss_pallas.py``. The whole loss
step runs in two launches, one CUDA thread per sample:

* **forward** (K1 cold, K3 epoch-warm): the terms at the observed next
  state, the detached hybrid cone solve and the loss assembly
  (:func:`fused_loss_fwd`, :func:`fused_loss_fwd_warm`).
* **backward** (K2, shared by both): the gradient does not flow through
  the solve (envelope theorem), so the kernel recomputes the terms and
  the assembly at the saved impulse and differentiates them with respect
  to the derived scalar parameters (summed over the batch) and the states
  (:func:`fused_loss_bwd`).

Two sets of kernels serve the JAX kernels' model class (the fused path's
models whose geometries are planes, boxes, polygons and spheres):

* the box cube's own (:func:`cube_cover`; ``csrc/contactnets_loss.cu`` on
  ``cube_terms.cuh``, K2 a hand-written reverse-mode sweep,
  ``cube_adjoint.cuh``);
* the model-generic ones (:func:`generic_cover`; ``csrc/model_loss.cuh``
  on ``model_terms.cuh``, K2 a hand-written reverse-mode sweep over the
  kinematic tree, ``model_adjoint.cuh``), which cover every model of the
  class: each size (:class:`ModelSize`: bodies, ``n_q``, ``n_v``, derived
  scalars, polygon vertices, each pair's witnesses) builds at first use
  (``soa_kernels.build_instances``), as the polygon cube's, the elbow's,
  a ball's or a box and a sphere on one body. They read the model from a
  descriptor (:func:`model_descriptor`).

Beside each kernel stands its plain PyTorch version (:func:`plain_loss_fwd`,
:func:`plain_loss_fwd_warm`, :func:`plain_loss_bwd`), which serves every
model: the wrappers run it for CPU tensors, and for CUDA tensors launch
the kernel or raise (a model outside the class, such as an ICNN geometry,
raises ``NotImplementedError``). The ``launches`` attribute of each wrapper counts
its kernel's launches, ``launches_by`` by instantiation (``"cube"`` or a
size's name). The kernels take float32 and float64.

The chain from ``MultibodyParams`` to the packed derived vector
(``soa_terms.derive_scalar_params`` and :func:`pack_derived`) is ordinary
torch autograd outside the kernels; :class:`_FusedLoss` and
:class:`_FusedLossWarm` take it from there.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.multibody.model import MultibodyModel
from dair_pll_tpu_torch.multibody.soa_terms import (
    derive_scalar_params, soa_loss_assemble, soa_loss_parts, supports_fused)
from dair_pll_tpu_torch.ops import soa, soa_kernels, soa_solver

_NOT_COVERED = (
    "the ContactNets loss kernels cover the JAX kernels' model class "
    "(supports_fused_kernel: plane against box, polygon or sphere, free, "
    "revolute, prismatic and fixed joints, at most one actuator a body); "
    "this model is outside it")
#: Geometries of the JAX kernels' model class (``supports_fused_kernel``).
_KERNEL_GEOMETRIES = ("plane", "box", "polygon", "sphere")
#: A box's vertices: the fewest the generic kernels' vertex sort takes.
_BOX_VERTICES = 8
_P, _I, _LL, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
#: The generic forward entries: the descriptor's address first, and after
#: ``valid`` the scratch ``pack`` and its count of values.
_MODEL_FWD = [_P] * 8 + [_LL, _LL, _D, _D, _I, _I, _P]
_MODEL_FWD_WARM = [_P] * 9 + [_LL, _LL, _D, _D, _I, _I, _P]
_BWD = [_P] * 10 + [_LL, _D, _D, _P]
_JOINT = {"free": 0, "revolute": 1, "prismatic": 2, "fixed": 3, "weld": 3}
_GEOMETRY = {"plane": 0, "box": 1, "polygon": 2, "sphere": 3}


# -- covers ------------------------------------------------------------------------
def cube_cover(model: MultibodyModel) -> bool:
    """Whether the box cube's kernels cover the model: one free body with
    a box (in the body frame, 4 witness points) against a ground plane (in
    the world frame), no actuation."""
    identity = tuple(tuple(row) for row in np.eye(3))
    if model.n_bodies != 1 or model.n_u != 0 or (model.n_q, model.n_v) != \
            (7, 6):
        return False
    if model.bodies[0].joint.joint_type != "free":
        return False
    if len(model.geometries) != 2 or model.collision_candidates != ((0, 1),):
        return False
    plane, box = model.geometries
    return (plane.geom_type == "plane" and plane.body == -1 and
            box.geom_type == "box" and box.body == 0 and
            box.n_query == 4 and
            all(tuple(g.R_BG) == identity and tuple(g.p_BG) == (0, 0, 0)
                for g in (plane, box)))


class ModelSize(NamedTuple):
    """The generic kernels' size of a model (``ModelSize`` of
    ``csrc/model_terms.cuh``): bodies, ``n_q``, ``n_v``, the most derived
    scalars, the vertices the convex's sort takes (a box's 8, or the
    largest polygon's count) and each plane-convex pair's witnesses, in
    the packed contact order."""
    n_bodies: int
    n_q: int
    n_v: int
    pmax: int
    n_vertices: int
    witnesses: Tuple[int, ...]

    @property
    def name(self) -> str:
        """``b<bodies>_q<n_q>_v<n_v>_k<k>``, then the witnesses where a
        pair has other than 4, the vertices beyond 8 and the derived
        scalars beyond the usual count."""
        name = (f"b{self.n_bodies}_q{self.n_q}_v{self.n_v}_"
                f"k{sum(self.witnesses)}")
        if any(w != 4 for w in self.witnesses):
            name += "_w" + "_".join(map(str, self.witnesses))
        if self.n_vertices != _BOX_VERTICES:
            name += f"_n{self.n_vertices}"
        if self.pmax != _pmax(self.n_bodies, len(self.witnesses),
                              self.n_vertices):
            name += f"_p{self.pmax}"
        return name

    @property
    def template(self) -> str:
        """The C++ type of the size."""
        return (f"ModelSize<{self.n_bodies}, {self.n_q}, {self.n_v}, "
                f"{self.pmax}, {self.n_vertices}, "
                f"{', '.join(map(str, self.witnesses))}>")


def _pmax(n_bodies: int, n_pairs: int, n_vertices: int) -> int:
    """Derived scalars a size's kernels take: each body's 10 and a
    geometry's friction, the world's plane, and each pair's shape."""
    return 11 * n_bodies + 1 + 3 * n_vertices * n_pairs


def model_size(model: MultibodyModel) -> Optional[ModelSize]:
    """The generic kernels' size of a model of the JAX kernels' class
    (``supports_fused_kernel``: plane against box, polygon or sphere), or
    ``None`` outside it: also for more actuators than bodies, a polygon
    with fewer vertices than witnesses or a pair whose witnesses are not
    the convex's."""
    if not supports_fused(model) or any(
            g.geom_type not in _KERNEL_GEOMETRIES for g in model.geometries):
        return None
    if model.n_u > model.n_bodies or not model.collision_candidates:
        return None
    n_vertices = _BOX_VERTICES
    for (_, b), witnesses in zip(model.collision_candidates,
                                 model.contacts_per_pair):
        g = model.geometries[b]
        if g.geom_type == "sphere":
            if witnesses != 1:
                return None
        elif g.geom_type == "polygon":
            if not 1 <= witnesses <= len(g.vertices_init):
                return None
            n_vertices = max(n_vertices, len(g.vertices_init))
        elif not 1 <= witnesses <= _BOX_VERTICES:
            return None
    n_pairs = len(model.collision_candidates)
    return ModelSize(model.n_bodies, model.n_q, model.n_v,
                     max(derived_size(model),
                         _pmax(model.n_bodies, n_pairs, n_vertices)),
                     n_vertices, tuple(model.contacts_per_pair))


def generic_size(model: MultibodyModel) -> Optional[str]:
    """The name of the generic kernels' size that covers the model
    (:func:`model_size`), or ``None``."""
    size = model_size(model)
    return None if size is None else size.name


def generic_cover(model: MultibodyModel) -> bool:
    """Whether the model-generic kernels cover the model
    (:func:`generic_size`)."""
    return generic_size(model) is not None


def _require_generic(model: MultibodyModel) -> ModelSize:
    """The generic size that covers the model; raises outside it."""
    size = model_size(model)
    if size is None:
        raise NotImplementedError(_NOT_COVERED)
    return size


def loss_instances(size: ModelSize, dtype) -> Tuple[soa_kernels.Instance,
                                                     soa_kernels.Instance]:
    """The generic K1 and K3 (one library) and K2 (another) of a size in
    ``dtype``, built at first use."""
    s, t = soa_kernels._SUFFIX[dtype], soa_kernels._CTYPE[dtype]
    head = (f'#include "model_loss.cuh"\n'
            f"using Size = {size.template};\n")
    fwd = soa_kernels.Instance(
        f"contactnets_loss_fwd_{size.name}_{s}",
        head + f"DEFINE_MODEL_FWD_ENTRY(Size, {size.name}, {t}, {s}, "
        f"kFwdLanes<Size>)\n",
        tuple((f"contactnets_loss_{kind}_{size.name}_{s}", tuple(args),
               soa_kernels._I)
              for kind, args in (("fwd", _MODEL_FWD),
                                 ("fwd_warm", _MODEL_FWD_WARM))))
    bwd = soa_kernels.Instance(
        f"contactnets_loss_bwd_{size.name}_{s}",
        head + f"DEFINE_MODEL_BWD_ENTRIES(Size, {size.name}, {t}, {s})\n"
        'extern "C" long long model_loss_bwd_scratch(long long B, int n_p) '
        "{\n  return model_blocks(B, kModelBwdThreads) * n_p;\n}\n"
        'extern "C" int model_loss_design() '
        f"{{\n  return model_design<{t}, Size>();\n}}\n",
        ((f"contactnets_loss_bwd_{size.name}_{s}", tuple([_P] + _BWD),
          soa_kernels._I),
         ("model_loss_bwd_scratch", (_LL, soa_kernels._I), _LL),
         ("model_loss_design", (), soa_kernels._I)))
    return fwd, bwd


def loss_design(size: ModelSize, dtype) -> Dict[str, object]:
    """The generic K1's, K3's and K2's design at a size in ``dtype``, as
    its built K2 library gives it (``model_design`` of
    ``csrc/model_loss.cuh``): ``lanes``, K1's and K3's lanes a sample
    (``kFwdLanes``); ``const_body``, the free body's joint as compile-time
    constants (``kConstFreeBody``); ``cold_exits``, K1's cold solve
    leaving its loops at their exact fixed points (``kFwdColdExits``);
    ``grad_shared``, K2's per-sample gradient in shared memory
    (``kBwdGradShared``)."""
    bits = soa_kernels.entry(loss_instances(size, dtype)[1],
                             "model_loss_design")()
    return {"lanes": bits & 255, "const_body": bool(bits >> 8 & 1),
            "cold_exits": bool(bits >> 9 & 1),
            "grad_shared": bool(bits >> 10 & 1)}


#: The box cube's own K1, K3 and K2, both types (``csrc/
#: contactnets_loss.cuh``).
CUBE_INSTANCE = soa_kernels.Instance(
    "contactnets_loss_cube", '#include "contactnets_loss.cuh"\n',
    tuple((f"contactnets_loss_{kind}_cube_{s}", tuple(args), soa_kernels._I)
          for kind, args in (("fwd", [_P] * 6 + [_LL, _D, _D, _I, _I, _P]),
                             ("fwd_warm",
                              [_P] * 7 + [_LL, _D, _D, _I, _I, _P]),
                             ("bwd", _BWD))
          for s in ("f32", "f64")) +
    (("contactnets_loss_bwd_scratch", (_LL,), _LL),))


def _instance(model: MultibodyModel) -> str:
    """The kernels' instantiation for the model: ``"cube"`` or a generic
    size's name; raises for a model outside both covers."""
    return "cube" if cube_cover(model) else _require_generic(model).name


# -- the model descriptor ------------------------------------------------------------
class _BodyDesc(ctypes.Structure):
    """``BodyDesc`` of ``csrc/model_terms.cuh``."""
    _fields_ = [("joint", ctypes.c_int), ("parent", ctypes.c_int),
                ("q_off", ctypes.c_int), ("v_off", ctypes.c_int),
                ("u_index", ctypes.c_int),
                ("R_PJ", ctypes.c_double * 3 * 3),
                ("p_PJ", ctypes.c_double * 3), ("axis", ctypes.c_double * 3)]


class _GeomDesc(ctypes.Structure):
    """``GeomDesc`` of ``csrc/model_terms.cuh``."""
    _fields_ = [("kind", ctypes.c_int), ("body", ctypes.c_int),
                ("n_vertices", ctypes.c_int), ("mu_index", ctypes.c_int),
                ("shape_index", ctypes.c_int),
                ("R_BG", ctypes.c_double * 3 * 3),
                ("p_BG", ctypes.c_double * 3)]


@functools.lru_cache(maxsize=None)
def _desc_type(n_bodies: int, n_pairs: int):
    """``ModelDesc<Z>`` of ``csrc/model_terms.cuh`` for a size."""
    return type(f"ModelDesc_{n_bodies}_{n_pairs}", (ctypes.Structure,), {
        "_fields_": [("body", _BodyDesc * n_bodies),
                     ("plane", _GeomDesc * n_pairs),
                     ("convex", _GeomDesc * n_pairs),
                     ("n_params", ctypes.c_int), ("n_u", ctypes.c_int)]})


def _matrix(values):
    return (ctypes.c_double * 3 * 3)(*((ctypes.c_double * 3)(*map(float, row))
                                       for row in values))


def _shape_size(spec) -> int:
    """Derived shape scalars of a geometry: a box's half lengths, a
    polygon's vertices, a sphere's radius."""
    if spec.geom_type == "box":
        return 3
    if spec.geom_type == "polygon":
        return 3 * len(spec.vertices_init)
    return 1 if spec.geom_type == "sphere" else 0


def _shape_indices(model: MultibodyModel):
    """Each geometry's first shape scalar in the packed derived vector."""
    index = 10 * model.n_bodies + len(model.geometries)
    out = []
    for spec in model.geometries:
        out.append(index)
        index += _shape_size(spec)
    return out


@functools.lru_cache(maxsize=None)
def model_descriptor(model: MultibodyModel) -> ctypes.Structure:
    """The generic kernels' descriptor of a model they cover: each body's
    joint (kind, parent, coordinates' offsets, actuator row, frame, axis)
    and each pair's plane and convex geometry (kind, body, vertex count,
    friction and shape indices in the derived vector, pose)."""
    _require_generic(model)
    desc = _desc_type(model.n_bodies, len(model.collision_candidates))()
    u_index = 0
    for i, body in enumerate(model.bodies):
        joint = body.joint
        entry = desc.body[i]
        entry.joint, entry.parent = _JOINT[joint.joint_type], joint.parent
        entry.q_off = model.body_q_offset(i)
        entry.v_off = model.body_v_offset(i)
        entry.u_index = -1
        if joint.joint_type in ("revolute", "prismatic") and joint.actuated:
            entry.u_index = u_index
            u_index += 1
        entry.R_PJ = _matrix(joint.R_PJ)
        entry.p_PJ = (ctypes.c_double * 3)(*map(float, joint.p_PJ))
        entry.axis = (ctypes.c_double * 3)(*map(float, joint.axis))
    shape = _shape_indices(model)
    for pair, (a, b) in enumerate(model.collision_candidates):
        for side, g in ((desc.plane[pair], a), (desc.convex[pair], b)):
            spec = model.geometries[g]
            side.kind, side.body = _GEOMETRY[spec.geom_type], spec.body
            side.n_vertices = (len(spec.vertices_init)
                               if spec.geom_type == "polygon" else 0)
            side.mu_index = 10 * model.n_bodies + g
            side.shape_index = shape[g]
            side.R_BG = _matrix(spec.R_BG)
            side.p_BG = (ctypes.c_double * 3)(*map(float, spec.p_BG))
    desc.n_params = derived_size(model)
    desc.n_u = model.n_u
    return desc


# -- derived-parameter packing ---------------------------------------------------
def derived_size(model: MultibodyModel) -> int:
    """Number of packed derived scalars: each body's inertial vector (10),
    each geometry's friction (1), a box's half lengths (3), a polygon's
    vertices (3 each), a sphere's radius (1)."""
    return 10 * model.n_bodies + len(model.geometries) + sum(
        _shape_size(spec) for spec in model.geometries)


def pack_derived(model: MultibodyModel, derived) -> Tensor:
    """Flattens the derived parameters (``soa_terms.derive_scalar_params``)
    into the ``(P,)`` vector the kernels take, in the layout
    :func:`unpack_scalarized` mirrors. Differentiable: the gradient back to
    ``MultibodyParams`` is ordinary autograd."""
    parts = [derived["pi"].reshape(-1), derived["mu"].reshape(-1)]
    for spec, entry in zip(model.geometries, derived["geom"]):
        if spec.geom_type == "box":
            parts.append(entry["half"].reshape(-1))
        elif spec.geom_type == "polygon":
            parts.append(entry["verts"].reshape(-1))
        elif spec.geom_type == "sphere":
            parts.append(entry["radius"].reshape(1))
    return torch.cat(parts)


def unpack_scalarized(model: MultibodyModel,
                      read: Callable[[int], Tensor]) -> dict:
    """Rebuilds the scalarized derived structure
    (``soa_terms.scalarize_derived``'s) from an indexed scalar reader."""
    index = iter(range(derived_size(model)))

    def nxt():
        return read(next(index))

    pi = [[nxt() for _ in range(10)] for _ in range(model.n_bodies)]
    mu = [nxt() for _ in model.geometries]
    geom = []
    for spec in model.geometries:
        if spec.geom_type == "box":
            geom.append({"half": [nxt() for _ in range(3)]})
        elif spec.geom_type == "polygon":
            geom.append({"verts": [[nxt() for _ in range(3)]
                                   for _ in spec.vertices_init]})
        elif spec.geom_type == "sphere":
            geom.append({"radius": nxt()})
        else:
            geom.append({})
    return {"pi": pi, "mu": mu, "geom": geom}


# -- plain versions --------------------------------------------------------------
def _split_state(model: MultibodyModel, block: Tensor):
    """``(n_x [+ n_u], B)`` -> ``(q, v, u)`` lists of ``(B,)`` rows."""
    n_q, n_v = model.n_q, model.n_v
    rows = soa.unstack(block)
    return rows[:n_q], rows[n_q:n_q + n_v], rows[n_q + n_v:]


def _parts(model, pvec, xin, xp, dt):
    sp = unpack_scalarized(model, lambda i: pvec[i])
    _, v, u = _split_state(model, xin)
    q_plus, v_plus, _ = _split_state(model, xp)
    return soa_loss_parts(model, sp, v, q_plus, v_plus, u, dt)


def plain_loss_fwd(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                   xp: Tensor, dt: float, eps: float, ipm_iterations: int,
                   newton_iterations: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K1: ``pvec (P,)``, ``xin (n_x + n_u, B)``,
    ``xp (n_x, B)`` -> ``loss (B,)``, ``force (3, k, B)``, ``valid (B,)``."""
    with torch.no_grad():
        M, Jc, phi, qc, dv = _parts(model, pvec, xin, xp, dt)
        force, valid = soa_solver.solve_contact_impulse_soa(
            M, Jc, qc, eps, ipm_iterations, newton_iterations)
        loss = soa_loss_assemble(M, Jc, phi, qc, dv, force, valid, eps)
    return loss, torch.stack(force), valid


def plain_loss_fwd_warm(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                        xp: Tensor, fprev: Tensor, dt: float, eps: float,
                        ipm_iterations: int, newton_iterations: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K3: as :func:`plain_loss_fwd`, with the solve
    warm-started from ``w = M^{-1} J^T fprev``, ``fprev (3, k, B)``."""
    with torch.no_grad():
        M, Jc, phi, qc, dv = _parts(model, pvec, xin, xp, dt)
        w_carry = soa.spd_solve(M, soa_solver.jt_dot(Jc, fprev.unbind(0)))
        force, _, valid = soa_solver.solve_warm_hybrid_soa(
            M, Jc, qc, w_carry, eps, ipm_iterations, newton_iterations)
        loss = soa_loss_assemble(M, Jc, phi, qc, dv, force, valid, eps)
    return loss, torch.stack(force), valid


def plain_loss_bwd(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                   xp: Tensor, force: Tensor, valid: Tensor, ct: Tensor,
                   dt: float, eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K2: torch autograd of ``sum(ct * loss)`` through
    the terms and the assembly at the saved ``force (3, k, B)`` ->
    ``dp (P,)``, ``dxin``, ``dxp`` shaped as the inputs."""
    inputs = [t.detach().requires_grad_() for t in (pvec, xin, xp)]
    with torch.enable_grad():
        M, Jc, phi, qc, dv = _parts(model, *inputs, dt)
        loss = soa_loss_assemble(M, Jc, phi, qc, dv, force.unbind(0), valid,
                                 eps)
        grads = torch.autograd.grad(torch.sum(loss * ct), inputs,
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, inputs))


# -- kernel wrappers -------------------------------------------------------------
def _check_launch(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                  xp: Tensor) -> Tuple[str, int]:
    """Raises unless the kernels take these inputs; returns the
    instantiation (:func:`_instance`) and the batch size."""
    instance = _instance(model)
    dtype = pvec.dtype
    if dtype not in soa_kernels._SUFFIX:
        raise TypeError(f"no kernel for dtype {dtype}")
    B = xin.shape[-1]
    n_x = model.n_q + model.n_v
    soa_kernels.check_tensor("pvec", pvec, (derived_size(model),), dtype,
                             pvec.device)
    soa_kernels.check_tensor("xin", xin, (n_x + model.n_u, B), dtype,
                             pvec.device)
    soa_kernels.check_tensor("xp", xp, (n_x, B), dtype, pvec.device)
    return instance, B


def _entry(model: MultibodyModel, kind: str, instance: str,
           dtype) -> Tuple[Callable, tuple]:
    """The library's entry point of a kernel (``kind`` ``fwd``,
    ``fwd_warm`` or ``bwd``) for an instantiation, and the arguments that
    lead its call: the model descriptor's address for a generic size."""
    s = soa_kernels._SUFFIX[dtype]
    if instance == "cube":
        return soa_kernels.entry(CUBE_INSTANCE,
                                 f"contactnets_loss_{kind}_cube_{s}"), ()
    fwd, bwd = loss_instances(_require_generic(model), dtype)
    fn = soa_kernels.entry(bwd if kind == "bwd" else fwd,
                           f"contactnets_loss_{kind}_{instance}_{s}")
    return fn, (ctypes.addressof(model_descriptor(model)),)


def _fwd_scratch(model: MultibodyModel, instance: str, like: Tensor,
                 B: int):
    """The scratch a forward entry takes after ``valid``: none for the
    cube's; for a generic size its ``pack``, the terms each sample's thread
    hands the sample's lanes (``kPackValues`` of ``csrc/model_terms.cuh``
    a sample: M, J, qc, phi, dv), and the pack's count of values, which
    the entry checks. Returns the tensor (kept until the launch is
    enqueued) and the arguments."""
    if instance == "cube":
        return None, ()
    n_v, k = model.n_v, model.n_contacts
    n = (n_v * n_v + 3 * n_v * k + 4 * k + n_v) * B
    pack = torch.empty((n,), dtype=like.dtype, device=like.device)
    return pack, (pack.data_ptr(), n)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _outputs(model: MultibodyModel, like: Tensor, B: int):
    k = model.n_contacts
    return (torch.empty((B,), dtype=like.dtype, device=like.device),
            torch.empty((3, k, B), dtype=like.dtype, device=like.device),
            torch.empty((B,), dtype=torch.bool, device=like.device))


def fused_loss_fwd(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                   xp: Tensor, dt: float, eps: float, ipm_iterations: int,
                   newton_iterations: int) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: ``(loss (B,), force (3, k, B), valid (B,))`` from
    ``pvec (P,)``, ``xin (n_x + n_u, B)``, ``xp (n_x, B)``. CPU tensors
    run :func:`plain_loss_fwd`; CUDA tensors launch the kernel on the
    current stream or raise."""
    if soa_kernels.on_cpu(pvec, xin, xp):
        return plain_loss_fwd(model, pvec, xin, xp, dt, eps, ipm_iterations,
                              newton_iterations)
    instance, B = _check_launch(model, pvec, xin, xp)
    loss, force, valid = _outputs(model, pvec, B)
    if B == 0:
        return loss, force, valid
    fn, lead = _entry(model, "fwd", instance, pvec.dtype)
    with torch.cuda.device(pvec.device):
        _pack, scratch = _fwd_scratch(model, instance, pvec, B)
        err = fn(*lead, pvec.data_ptr(), xin.data_ptr(), xp.data_ptr(),
                 loss.data_ptr(), force.data_ptr(), valid.data_ptr(),
                 *scratch, B, float(dt), float(eps), int(ipm_iterations),
                 int(newton_iterations),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ContactNets loss forward (K1)")
    soa_kernels.count_launch(fused_loss_fwd, instance)
    return loss, force, valid


def fused_loss_fwd_warm(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                        xp: Tensor, fprev: Tensor, dt: float, eps: float,
                        ipm_iterations: int, newton_iterations: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """K3: as :func:`fused_loss_fwd`, with the solve warm-started from the
    previous impulses ``fprev (3, k, B)``."""
    if soa_kernels.on_cpu(pvec, xin, xp, fprev):
        return plain_loss_fwd_warm(model, pvec, xin, xp, fprev, dt, eps,
                                   ipm_iterations, newton_iterations)
    instance, B = _check_launch(model, pvec, xin, xp)
    soa_kernels.check_tensor("fprev", fprev, (3, model.n_contacts, B),
                             pvec.dtype, pvec.device)
    loss, force, valid = _outputs(model, pvec, B)
    if B == 0:
        return loss, force, valid
    fn, lead = _entry(model, "fwd_warm", instance, pvec.dtype)
    with torch.cuda.device(pvec.device):
        _pack, scratch = _fwd_scratch(model, instance, pvec, B)
        err = fn(*lead, pvec.data_ptr(), xin.data_ptr(), xp.data_ptr(),
                 fprev.data_ptr(), loss.data_ptr(), force.data_ptr(),
                 valid.data_ptr(), *scratch, B, float(dt), float(eps),
                 int(ipm_iterations), int(newton_iterations),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ContactNets loss warm forward (K3)")
    soa_kernels.count_launch(fused_loss_fwd_warm, instance)
    return loss, force, valid


def fused_loss_bwd(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                   xp: Tensor, force: Tensor, valid: Tensor, ct: Tensor,
                   dt: float, eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K2: the gradient of ``sum(ct * loss)`` at the saved impulse,
    ``(dp (P,), dxin, dxp)``. CPU tensors run :func:`plain_loss_bwd`; CUDA
    tensors launch the kernel (and its pass that sums the blocks' partial
    sums of ``dp`` in a fixed order) or raise."""
    if soa_kernels.on_cpu(pvec, xin, xp, force, valid, ct):
        return plain_loss_bwd(model, pvec, xin, xp, force, valid, ct, dt,
                              eps)
    instance, B = _check_launch(model, pvec, xin, xp)
    soa_kernels.check_tensor("force", force, (3, model.n_contacts, B),
                             pvec.dtype, pvec.device)
    soa_kernels.check_tensor("valid", valid, (B,), torch.bool, pvec.device)
    soa_kernels.check_tensor("ct", ct, (B,), pvec.dtype, pvec.device)
    dxin = torch.empty_like(xin)
    dxp = torch.empty_like(xp)
    if B == 0:
        return torch.zeros_like(pvec), dxin, dxp
    dp = torch.empty_like(pvec)
    n_scratch = (
        soa_kernels.entry(CUBE_INSTANCE, "contactnets_loss_bwd_scratch")(B)
        if instance == "cube" else soa_kernels.entry(
            loss_instances(_require_generic(model), pvec.dtype)[1],
            "model_loss_bwd_scratch")(B, pvec.numel()))
    partial = torch.empty((n_scratch,), dtype=pvec.dtype, device=pvec.device)
    fn, lead = _entry(model, "bwd", instance, pvec.dtype)
    with torch.cuda.device(pvec.device):
        err = fn(*lead, pvec.data_ptr(), xin.data_ptr(), xp.data_ptr(),
                 force.data_ptr(), valid.data_ptr(), ct.data_ptr(),
                 partial.data_ptr(), dp.data_ptr(), dxin.data_ptr(),
                 dxp.data_ptr(), B, float(dt), float(eps),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ContactNets loss backward (K2)")
    soa_kernels.count_launch(fused_loss_bwd, instance)
    return dp, dxin, dxp


for _wrapper in (fused_loss_fwd, fused_loss_fwd_warm, fused_loss_bwd):
    soa_kernels.reset_launches(_wrapper)


# -- autograd ----------------------------------------------------------------------
def _backward(ctx, ct: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 at the impulse the forward saved: ``(dp, dxin, dxp)``."""
    pvec, xin, xp, force, valid = ctx.saved_tensors
    return fused_loss_bwd(ctx.model, pvec, xin, xp, force, valid,
                          ct.contiguous(), ctx.dt, ctx.eps)


class _FusedLoss(torch.autograd.Function):
    """``(pvec, xin, xp) -> loss (B,)``: K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, pvec, xin, xp, model, dt, eps, ipm_iterations,
                newton_iterations):
        loss, force, valid = fused_loss_fwd(model, pvec, xin, xp, dt, eps,
                                            ipm_iterations,
                                            newton_iterations)
        ctx.save_for_backward(pvec, xin, xp, force, valid)
        ctx.model, ctx.dt, ctx.eps = model, dt, eps
        return loss

    @staticmethod
    def backward(ctx, ct):
        return (*_backward(ctx, ct), None, None, None, None, None)


class _FusedLossWarm(torch.autograd.Function):
    """``(pvec, xin, xp, fprev) -> (loss (B,), force (3, k, B))``: K3
    forward, K2 backward. ``force`` is the refreshed, detached impulse
    cache; ``fprev`` gets no gradient."""

    @staticmethod
    def forward(ctx, pvec, xin, xp, fprev, model, dt, eps, ipm_iterations,
                newton_iterations):
        loss, force, valid = fused_loss_fwd_warm(
            model, pvec, xin, xp, fprev, dt, eps, ipm_iterations,
            newton_iterations)
        ctx.save_for_backward(pvec, xin, xp, force, valid)
        ctx.model, ctx.dt, ctx.eps = model, dt, eps
        ctx.mark_non_differentiable(force)
        return loss, force

    @staticmethod
    def backward(ctx, ct, _ct_force):
        # fprev, the previous impulses, gets no gradient.
        return (*_backward(ctx, ct), None, None, None, None, None, None)


def _kernel_inputs(model, params, x, u, x_plus):
    pvec = pack_derived(model, derive_scalar_params(model, params))
    xin = torch.cat([x.T, u.T], dim=0) if model.n_u > 0 else x.T
    return pvec, xin.contiguous(), x_plus.T.contiguous()


def fused_contactnets_loss_kernel(model: MultibodyModel, params, x: Tensor,
                                  u: Tensor, x_plus: Tensor, dt: float,
                                  loss_epsilon: float, ipm_iterations: int,
                                  newton_iterations: int) -> Tensor:
    """Single-kernel ContactNets loss ``(B, n_x) -> (B,)`` with the kernel
    backward: the counterpart of ``soa_terms.soa_contactnets_loss``."""
    pvec, xin, xp = _kernel_inputs(model, params, x, u, x_plus)
    return _FusedLoss.apply(pvec, xin, xp, model, float(dt),
                            float(loss_epsilon), ipm_iterations,
                            newton_iterations)


def fused_contactnets_loss_kernel_warm(model: MultibodyModel, params,
                                       x: Tensor, u: Tensor, x_plus: Tensor,
                                       dt: float, loss_epsilon: float,
                                       ipm_iterations: int,
                                       newton_iterations: int,
                                       force_prev: Tensor
                                       ) -> Tuple[Tensor, Tensor]:
    """Epoch-warm single-kernel ContactNets loss: the solve warm-starts
    from ``force_prev (3, k, B)``, the impulses these samples solved to on
    a previous visit (zeros for cold samples). Returns ``(loss (B,),
    force (3, k, B))``, ``force`` the refreshed, detached cache."""
    pvec, xin, xp = _kernel_inputs(model, params, x, u, x_plus)
    return _FusedLossWarm.apply(pvec, xin, xp,
                                force_prev.detach().contiguous(), model,
                                float(dt), float(loss_epsilon),
                                ipm_iterations, newton_iterations)
