"""The port's fused ContactNets loss for the models of the generic loss
kernels (``dair_pll_tpu_torch/csrc/model_loss.cuh``) against the JAX
package's, float64: the elbow in boxes and in polygons, the polygon cube,
``pris2`` (a prismatic joint) and the actuated ``paddle``.

For all five, the packed derived scalars (``pack_derived``,
``derived_size``, ``unpack_scalarized``) equal JAX's at the same
parameters, carried across with ``params_from_numpy``, and the cold loss
and its impulses match JAX's ``soa_contactnets_loss`` (loss rtol 1e-9, atol
1e-12; impulses atol 1e-8, as ``test_torch_loss.py``).
``test_torch_elbow_gradients.py`` holds the gradients. Then the routes: which
kernels cover which model, the card's route for the elbow (the generic
kernels, by their entry points and launch counts, with the library and
the card stood in for) and for the ICNN elbow (the solve kernels), every
other size of the class covered, and a model outside it (the ICNN elbow)
raising.

The JAX side runs eagerly (``jax.disable_jit``), as in
``test_torch_loss.py``.
"""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from dair_pll_tpu.ops import soa_loss_pallas as jpack
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch.multibody import soa_terms as tterms
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem as TSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.ops import soa_kernels
from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
from dair_pll_tpu_torch.urdf import build_multibody_model as tbuild
from dair_pll_tpu_torch.ops import cone_kernels
from torch_parity import (COLD_BUDGET as COLD, DT, KERNEL_MODELS,
                          LOSS_EPS as EPS, kernel_case, kernel_port,
                          size_model_urdfs)

LOSS_RTOL, LOSS_ATOL = 1e-9, 1e-12
FORCE_TOL = 1e-8
#: The generic kernels' size of each parity model.
SIZES = {"elbow": "b2_q8_v7_k8", "elbow_polygon": "b2_q8_v7_k8",
         "cube_polygon": "b1_q7_v6_k4", "pris2": "b2_q8_v7_k8",
         "paddle": "b2_q8_v7_k8"}


@pytest.fixture(scope="module")
def urdf_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("urdfs"))


@pytest.mark.parametrize("name", sorted(KERNEL_MODELS))
def test_derived_packing_matches_jax(urdf_dir, name):
    """The packed derived scalars, their count and their layout equal
    JAX's; the perturbed parameters cross with ``params_from_numpy``."""
    jmodel, tmodel, _, numpy_params, ref = kernel_case(name, urdf_dir)
    params = params_from_numpy(tmodel, *numpy_params)
    pvec = lk.pack_derived(tmodel, tterms.derive_scalar_params(tmodel,
                                                               params))
    np.testing.assert_allclose(pvec.detach().numpy(), ref["pvec"],
                               rtol=1e-12, atol=0)
    assert lk.derived_size(tmodel) == jpack.derived_size(jmodel) == \
        pvec.numel()
    assert lk.unpack_scalarized(tmodel, lambda i: i) == \
        jpack.unpack_scalarized(jmodel, lambda i: i)


@pytest.mark.parametrize("name", sorted(KERNEL_MODELS))
def test_cold_loss_and_impulses_match_jax(urdf_dir, name):
    """The fused cold loss through the training entry point, and the
    plain version's impulses and valid mask, match JAX's; the
    transitions reach contact."""
    _, _, _, _, ref = kernel_case(name, urdf_dir)
    system, params, x, x_plus, u = kernel_port(name, urdf_dir)
    with torch.no_grad():
        loss = system.contactnets_loss_batch(params, x, u, x_plus,
                                             use_fused=True)
        _, force, valid = tterms.soa_contactnets_loss(
            system.model, params, x, u, x_plus, DT, EPS, *COLD)
    np.testing.assert_allclose(loss.numpy(), ref["loss"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(torch.stack(force).numpy(), ref["force"],
                               rtol=FORCE_TOL, atol=FORCE_TOL)
    np.testing.assert_array_equal(valid.numpy(), ref["valid"])
    assert np.all(ref["valid"])
    assert np.mean(np.max(ref["force"][0], axis=0) > 1e-6) > 0.5


def _size_model(name, urdf_dir):
    urdfs, representation = size_model_urdfs(name, urdf_dir)
    return tbuild(urdfs, **({} if representation is None else
                            {"mesh_representation": representation}))


def test_kernel_covers(urdf_dir):
    """The box cube's kernels cover the box cube alone; the generic
    kernels the five parity models (and the box cube), each at its size,
    and every other model of the JAX kernels' class, each at a size of
    its own built at first use: a sphere (the ball), a box and a sphere on
    one body (witnesses 4 + 1), a polygon of 10 vertices; the three cubes'
    k = 15 passes K6's check. The ICNN elbow is outside the class, and
    the wrappers raise for it."""
    cube = tbuild({"cube": tassets.get_asset("cube")})
    assert lk.cube_cover(cube) and lk.generic_size(cube) == "b1_q7_v6_k4"
    for name, size in SIZES.items():
        model = kernel_case(name, urdf_dir)[1]
        assert not lk.cube_cover(model)
        assert lk.generic_size(model) == size and lk.generic_cover(model)
        assert lk.model_descriptor(model).n_params == lk.derived_size(model)
    for name, size in (("ball", "b1_q7_v6_k1_w1"),
                       ("box_sphere", "b1_q7_v6_k5_w4_1"),
                       ("prism10", "b1_q7_v6_k4_n10")):
        model = _size_model(name, urdf_dir)
        assert not lk.cube_cover(model) and lk.generic_cover(model)
        assert lk.generic_size(model) == size
        assert lk.model_descriptor(model).n_params == lk.derived_size(model)
    three = _size_model("three_cubes", urdf_dir)
    assert three.n_contacts == 15 and not lk.generic_cover(three)
    assert cone_kernels._check(torch.zeros(2, 45, 45),
                               torch.zeros(2, 45)) == (2, 15)
    icnn_elbow = tbuild({"elbow": tassets.get_asset("elbow_mesh")})
    assert not lk.cube_cover(icnn_elbow) and not lk.generic_cover(icnn_elbow)
    xin = torch.zeros(15, 2).to("meta")
    pvec = torch.zeros(lk.derived_size(icnn_elbow)).to("meta")
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(soa_kernels, "on_cpu", lambda *ts: False)
        with pytest.raises(NotImplementedError, match="outside"):
            lk.fused_loss_fwd(icnn_elbow, pvec, xin, xin, DT, EPS, *COLD)
        with pytest.raises(NotImplementedError, match="outside"):
            lk.model_descriptor(icnn_elbow)


class _Reached(Exception):
    pass


@pytest.mark.parametrize("asset", ["elbow", "elbow_mesh"])
def test_loss_route_by_model_off_the_cpu(monkeypatch, asset):
    """On a device other than the CPU (the meta device stands in for the
    card), the elbow's cold and warm losses go to the loss kernels K1 and
    K3, the ICNN elbow's to the plain terms with the solve kernels K4 and
    K5 at (n_v, k) = (7, 8)."""
    reached = []

    def stand_in(label):
        def wrapper(*args, **kwargs):
            if label in ("K4", "K5"):
                assert tuple(args[1].shape[1:3]) == (7, 8)
            reached.append(label)
            raise _Reached(label)
        return wrapper

    for module, name, label in (
            (lk, "fused_loss_fwd", "K1"), (lk, "fused_loss_fwd_warm", "K3"),
            (soa_kernels, "solve_contact_impulse_soa_cuda_packed", "K4"),
            (soa_kernels, "solve_warm_hybrid_soa_cuda_packed", "K5")):
        monkeypatch.setattr(module, name, stand_in(label))
    system = TSystem.from_urdfs({"elbow": tassets.get_asset(asset)}, DT,
                                device="meta")
    params = system.initial_params(torch.float32)
    x = torch.empty((4, 15), device="meta")
    u = torch.empty((4, 0), device="meta")
    with pytest.raises(_Reached):
        system.contactnets_loss_batch(params, x, u, x, use_fused=True)
    with pytest.raises(_Reached):
        system.contactnets_loss_batch_warm(
            params, x, u, x, torch.empty((3, 8, 4), device="meta"))
    assert reached == (["K1", "K3"] if asset == "elbow" else ["K4", "K5"])


def test_elbow_loss_calls_the_generic_entries(urdf_dir, monkeypatch):
    """With the card stood in for (the wrappers' device test, the entry
    points of the instantiations built at first use, ``torch.cuda``'s
    stream), the elbow's cold loss and its gradient call the generic entry
    points of the elbow's size, with the model descriptor leading, and
    count one launch each at that size."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args[0]))
            return 0
        return fn

    def instance_entry(instance, name=None):
        name = name or instance.entries[0][0]
        assert name in [e[0] for e in instance.entries]
        if name == "model_loss_bwd_scratch":
            return lambda b, p: b * p
        return entry(name)

    monkeypatch.setattr(soa_kernels, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(soa_kernels, "entry", instance_entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    system, params, x, x_plus, u = kernel_port("elbow", urdf_dir)
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    for wrapper in (lk.fused_loss_fwd, lk.fused_loss_bwd):
        soa_kernels.reset_launches(wrapper)
    loss = lk.fused_contactnets_loss_kernel(system.model, params, x, u,
                                            x_plus, DT, EPS, *COLD)
    torch.sum(loss).backward()
    desc = lk.model_descriptor(system.model)
    assert calls == [
        ("contactnets_loss_fwd_b2_q8_v7_k8_f64", ctypes.addressof(desc)),
        ("contactnets_loss_bwd_b2_q8_v7_k8_f64", ctypes.addressof(desc))]
    assert lk.fused_loss_fwd.launches_by == {"b2_q8_v7_k8": 1}
    assert lk.fused_loss_bwd.launches_by == {"b2_q8_v7_k8": 1}
