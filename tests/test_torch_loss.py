"""The port's fused cold ContactNets loss (``dair_pll_tpu_torch``) against
the JAX package's, float64, on the cube: the plain loss, its impulses and
valid mask, and its torch-autograd gradients with respect to the
parameters, ``x`` and ``x_plus``, against ``contactnets_loss_batch(...,
use_fused=True)`` and ``jax.grad`` (loss to rtol 1e-8, atol 1e-12, the bar
of ``tests/test_fused_loss.py``; impulses to 1e-8 as in
``test_torch_soa_solver.py``; gradients to rtol 1e-6, atol 1e-9, the bar
of ``tests/test_fused_kernel.py``). Also the packing of the derived
parameters, the CPU routing of the kernel wrappers, and the kernel
library's name.

The JAX side runs eagerly (``jax.disable_jit``): compiling its fused loss
gradient takes minutes on the CPU, evaluating it op by op seconds.
"""
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import assets as jassets
from dair_pll_tpu.multibody import soa_terms as jterms
from dair_pll_tpu.multibody.learnable_system import (
    MultibodyLearnableSystem as JSystem)
from dair_pll_tpu.ops import soa_loss_pallas as jpack
from dair_pll_tpu.ops import soa_solver as jsolver
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch.multibody import learnable_system
from dair_pll_tpu_torch.multibody import soa_terms as tterms
from dair_pll_tpu_torch.multibody.learnable_system import (
    FUSED_LOSS_MIN_BATCH, MultibodyLearnableSystem as TSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.ops import soa_kernels, soa_loss_kernels
from dair_pll_tpu_torch.urdf import build_multibody_model as tbuild
from torch_parity import (DT, cube_transitions, jax_params, params_numpy,
                          perturbed_params)

LOSS_RTOL, LOSS_ATOL = 1e-8, 1e-12
FORCE_TOL = 1e-8
GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-9


@functools.lru_cache(maxsize=None)
def _reference():
    """Transitions, perturbed parameters and the JAX results, computed
    once: per-sample loss, gradients of the summed loss with respect to
    (params, x, x_plus), the impulses and valid mask of the cold solve,
    and the packed derived vector."""
    jmodel = jbuild({"cube": jassets.get_asset("cube")})
    system = JSystem(jmodel, DT)
    rng = np.random.default_rng(21)
    x, x_plus = (jnp.asarray(t) for t in cube_transitions(rng))
    u = jnp.zeros((x.shape[0], 0))
    numpy_params = perturbed_params(
        rng, *params_numpy(jmodel.initial_params(jnp.float64)))
    params = jax_params(numpy_params)

    def total(p, xx, xxp):
        loss = system.contactnets_loss_batch(p, xx, u, xxp, use_fused=True)
        return jnp.sum(loss), loss

    with jax.disable_jit():
        (_, loss), grads = jax.value_and_grad(
            total, argnums=(0, 1, 2), has_aux=True)(params, x, x_plus)
        sp = jterms.scalarize_derived(
            jmodel, jterms.derive_scalar_params(jmodel, params))
        xT, xpT = x.T, x_plus.T
        M, Jc, _, qc, _ = jterms.soa_loss_parts(
            jmodel, sp, list(xT[7:]), list(xpT[:7]), list(xpT[7:]), [], DT)
        force, valid = jsolver.solve_contact_impulse_soa(
            M, Jc, qc, jnp.asarray(1e-3), 10, 10)
        pvec = jpack.pack_derived(
            jmodel, jterms.derive_scalar_params(jmodel, params))
    out = jax.tree_util.tree_map(np.asarray, {
        "loss": loss, "grads": grads, "force": jnp.stack(force),
        "valid": valid.reshape(-1), "pvec": pvec})
    return jmodel, np.asarray(x), np.asarray(x_plus), numpy_params, out


def _port_system():
    return TSystem.from_urdfs({"cube": tassets.get_asset("cube")}, DT,
                              device="cpu")


def _grads_of(loss_fn):
    """Port loss at the reference inputs and its autograd gradients:
    ``(loss, (d theta, d friction, d half_lengths), dx, dx_plus)``."""
    _, x, x_plus, numpy_params, _ = _reference()
    system = _port_system()
    params = params_from_numpy(system.model, *numpy_params)
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    xpt = torch.tensor(x_plus, requires_grad=True)
    loss = loss_fn(system, params, xt, xpt)
    torch.sum(loss).backward()
    return loss.detach(), [leaf.grad for leaf in leaves], xt.grad, xpt.grad


def _check_grads(param_grads, gx, gxp):
    _, _, _, _, ref = _reference()
    jp, jx, jxp = ref["grads"]
    expected = [jp.theta, jp.friction, jp.geometry[1]["half_lengths"]]
    for got, want in zip(param_grads, expected):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    np.testing.assert_allclose(gx.numpy(), jx, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gxp.numpy(), jxp, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_transitions_reach_contact():
    _, _, _, _, ref = _reference()
    assert np.all(ref["valid"])
    # Most samples press on the ground: nonzero normal impulses.
    assert np.mean(np.max(ref["force"][0], axis=0) > 1e-6) > 0.5


def test_plain_loss_and_impulses_match_jax():
    _, x, x_plus, numpy_params, ref = _reference()
    system = _port_system()
    params = params_from_numpy(system.model, *numpy_params)
    args = (params, torch.tensor(x), torch.zeros(x.shape[0], 0),
            torch.tensor(x_plus))
    loss = system.contactnets_loss_batch(*args, use_fused=True)
    np.testing.assert_allclose(loss.detach().numpy(), ref["loss"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    plain_loss, force, valid = tterms.soa_contactnets_loss(
        system.model, *args, DT, 1e-3, 10, 10)
    np.testing.assert_array_equal(plain_loss.detach().numpy(),
                                  loss.detach().numpy())
    force = torch.stack(force)
    np.testing.assert_allclose(force.numpy(), ref["force"], rtol=FORCE_TOL,
                               atol=FORCE_TOL)
    assert not force.requires_grad
    np.testing.assert_array_equal(valid.numpy(), ref["valid"])


def test_plain_loss_gradients_match_jax():
    u0 = torch.zeros(0)

    def loss_fn(system, params, x, x_plus):
        return system.contactnets_loss_batch(
            params, x, u0.expand(x.shape[0], 0), x_plus, use_fused=True)

    loss, param_grads, gx, gxp = _grads_of(loss_fn)
    np.testing.assert_allclose(loss.numpy(), _reference()[4]["loss"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _check_grads(param_grads, gx, gxp)


def test_kernel_wrappers_on_cpu_run_plain_versions():
    """With CPU tensors the kernel entry runs the plain versions through
    its autograd Function (K1's forward, K2's backward), matches JAX, and
    launches no kernel."""
    counters = (soa_loss_kernels.fused_loss_fwd,
                soa_loss_kernels.fused_loss_fwd_warm,
                soa_loss_kernels.fused_loss_bwd)
    for counter in counters:
        counter.launches = 0

    def loss_fn(system, params, x, x_plus):
        return soa_loss_kernels.fused_contactnets_loss_kernel(
            system.model, params, x, torch.zeros(x.shape[0], 0), x_plus,
            DT, 1e-3, 10, 10)

    loss, param_grads, gx, gxp = _grads_of(loss_fn)
    np.testing.assert_allclose(loss.numpy(), _reference()[4]["loss"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _check_grads(param_grads, gx, gxp)
    assert [counter.launches for counter in counters] == [0, 0, 0]


def test_derived_packing_matches_jax():
    jmodel, _, _, numpy_params, ref = _reference()
    tmodel = _port_system().model
    params = params_from_numpy(tmodel, *numpy_params)
    pvec = soa_loss_kernels.pack_derived(
        tmodel, tterms.derive_scalar_params(tmodel, params))
    np.testing.assert_allclose(pvec.detach().numpy(), ref["pvec"],
                               rtol=1e-12, atol=0)
    assert soa_loss_kernels.derived_size(tmodel) == \
        jpack.derived_size(jmodel) == 15
    assert soa_loss_kernels.unpack_scalarized(tmodel, lambda i: i) == \
        jpack.unpack_scalarized(jmodel, lambda i: i)
    # The packing is JAX's model-generic layout: the elbow's too.
    jelbow = jbuild({"elbow": jassets.get_asset("elbow")})
    elbow = tbuild({"elbow": tassets.get_asset("elbow")})
    assert soa_loss_kernels.derived_size(elbow) == \
        jpack.derived_size(jelbow) == 29
    assert soa_loss_kernels.unpack_scalarized(elbow, lambda i: i) == \
        jpack.unpack_scalarized(jelbow, lambda i: i)


def test_kernel_instantiation_covers_the_cube_only():
    """The box cube's own kernels cover the box cube alone; the generic
    kernels cover the elbow and the polygon cube at their sizes (and the
    box cube); the ICNN cube lies outside both covers."""
    cube = _port_system().model
    elbow = tbuild({"elbow": tassets.get_asset("elbow")})
    polygon = tbuild({"cube": tassets.get_asset("cube_mesh")},
                     mesh_representation="polygon")
    icnn = tbuild({"cube": tassets.get_asset("cube_mesh")})
    assert soa_loss_kernels.cube_cover(cube)
    assert not any(soa_loss_kernels.cube_cover(m)
                   for m in (elbow, polygon, icnn))
    assert [soa_loss_kernels.generic_size(m)
            for m in (cube, elbow, polygon, icnn)] == \
        ["b1_q7_v6_k4", "b2_q8_v7_k8", "b1_q7_v6_k4", None]


def test_small_batch_default_path_runs_vmapped(monkeypatch):
    """Below ``FUSED_LOSS_MIN_BATCH`` the default, like ``use_fused=False``,
    is the vmapped loss (the fused loss is never reached), and it matches
    the JAX package's vmapped loss (jitted) at the loss bar."""
    _, x, x_plus, numpy_params, _ = _reference()
    assert x.shape[0] < FUSED_LOSS_MIN_BATCH
    n = 4
    jsystem = JSystem(jbuild({"cube": jassets.get_asset("cube")}), DT)
    want = np.asarray(jax.jit(lambda p, a, b: jsystem.contactnets_loss_batch(
        p, a, jnp.zeros((n, 0)), b, use_fused=False))(
            jax_params(numpy_params), jnp.asarray(x[-n:]),
            jnp.asarray(x_plus[-n:])))

    def fused(*args, **kwargs):
        raise AssertionError("the fused loss was called")

    monkeypatch.setattr(learnable_system, "soa_contactnets_loss", fused)
    system = _port_system()
    params = params_from_numpy(system.model, *numpy_params)
    args = (params, torch.tensor(x[-n:]), torch.zeros(n, 0),
            torch.tensor(x_plus[-n:]))
    with torch.no_grad():
        for got in (system.contactnets_loss_batch(*args),
                    system.contactnets_loss_batch(*args, use_fused=False)):
            np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL)
    assert np.any(want != 0.0)


def test_library_name_hashes_every_source(tmp_path):
    """An instantiation's library file name changes with the bytes of any
    file under ``csrc/``, headers included, with the compiler's path and
    with the instantiation."""
    copy = tmp_path / "csrc"
    shutil.copytree(soa_kernels.SOURCE_DIR, copy)
    nvcc = "/usr/local/cuda/bin/nvcc"
    instance = soa_kernels.warm_instance(6, 4, torch.float64)
    name = soa_kernels.library_path(instance, str(copy), nvcc)
    assert name == soa_kernels.library_path(instance,
                                            soa_kernels.SOURCE_DIR, nvcc)
    headers = sorted(p for p in os.listdir(copy) if p.endswith(".cuh"))
    assert headers, "no headers under csrc/"
    for header in headers:
        path = copy / header
        original = path.read_bytes()
        path.write_bytes(original + b"\n")
        assert soa_kernels.library_path(instance, str(copy), nvcc) != name
        path.write_bytes(original)
    assert soa_kernels.library_path(instance, str(copy), nvcc) == name
    assert soa_kernels.library_path(instance, str(copy), nvcc + "x") != name
    other = soa_kernels.warm_instance(6, 5, torch.float64)
    assert soa_kernels.library_path(other, str(copy), nvcc) != name


def test_wrappers_refuse_mixed_devices():
    """A wrapper (the loss kernels', K5's and K4's) runs its plain version only
    when every input lies on the CPU; inputs on several devices raise
    before anything runs."""
    model = _port_system().model
    pvec = torch.zeros(15, dtype=torch.float64)
    xin = torch.zeros(13, 4, dtype=torch.float64)
    elsewhere = xin.to("meta")
    with pytest.raises(ValueError, match="several devices"):
        soa_loss_kernels.fused_loss_fwd(model, pvec, elsewhere, xin, DT,
                                        1e-3, 10, 10)
    with pytest.raises(ValueError, match="several devices"):
        soa_loss_kernels.fused_loss_fwd_warm(
            model, pvec, xin, xin, torch.zeros(3, 4, 4).to("meta"), DT, 1e-3,
            4, 10)
    with pytest.raises(ValueError, match="several devices"):
        soa_loss_kernels.fused_loss_bwd(
            model, pvec.to("meta"), xin, xin, torch.zeros(3, 4, 4),
            torch.ones(4, dtype=torch.bool), torch.ones(4), DT, 1e-3)
    with pytest.raises(ValueError, match="several devices"):
        soa_kernels.solve_warm_hybrid_soa_cuda_packed(
            torch.eye(6).reshape(36, 1), torch.zeros(3, 6, 4, 1),
            torch.zeros(3, 4, 1), torch.zeros(6, 1).to("meta"), 1e-4, 14, 6)
    with pytest.raises(ValueError, match="several devices"):
        soa_kernels.solve_contact_impulse_soa_cuda_packed(
            torch.eye(6).reshape(36, 1), torch.zeros(3, 6, 4, 1),
            torch.zeros(3, 4, 1).to("meta"), 1e-3, 10, 10)


def test_loss_entry_checks_parameter_device():
    """The entry refuses parameters that do not lie on the system's
    device, as it refuses states there."""
    _, x, x_plus, numpy_params, _ = _reference()
    system = _port_system()
    args = (torch.tensor(x), torch.zeros(x.shape[0], 0),
            torch.tensor(x_plus))
    elsewhere = params_from_numpy(system.model, *numpy_params, device="meta")
    with pytest.raises(ValueError, match="the system runs on cpu"):
        system.contactnets_loss_batch(elsewhere, *args, use_fused=True)
    with pytest.raises(ValueError, match="the system runs on cpu"):
        system.contactnets_loss_batch_warm(
            elsewhere, *args, torch.zeros(3, 4, x.shape[0]))
