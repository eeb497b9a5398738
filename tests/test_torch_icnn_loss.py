"""The port's ContactNets loss and training step for the deep-support
(ICNN) cube against the JAX package's, float64, at full width (depth 2,
width 256, 4 witness queries), on 16 transitions at perturbed parameters
carried across: 8 of ``torch_parity.cube_transitions`` (made for the box,
so deep in the initial ICNN, which is larger) and 8 of
``torch_parity.icnn_transitions`` (ICNN states near the ground and one
step of the port's rollout):
the terms; a cold step (the (10, 10) solve; per-sample loss, impulses,
valid mask and the gradient of every leaf, ``x`` and ``x_plus``); the seed
of the impulse cache (the warm call from zeros at (10, 10)); two
epoch-warm steps at (4, 10) (per-sample loss, refreshed cache and
gradients on the first); Adam at lr 1e-3 after each step
(``torch.optim.Adam`` against ``optax.adam``). Also the loss's route by
model and device, and the default mesh model's training on the CPU.

The JAX side is ``soa_terms.soa_contactnets_loss`` and
``soa_contactnets_loss_warm`` with ``solver_backend="xla"``, run eagerly
(``jax.disable_jit``) as in ``test_torch_loss.py``. Tolerances: terms rtol
1e-11 (``test_torch_terms.py``); loss rtol 1e-8, atol 1e-12
(``tests/test_fused_loss.py``); impulses 1e-8; gradients rtol 1e-6, atol
1e-10; parameters after each Adam step atol 1e-8.

The gradient with respect to the support-direction perturbations is
exactly zero in both: a support point of the piecewise-linear ICNN is
piecewise constant in its direction. JAX returns zeros; the perturbations
do not reach torch's graph, so their ``grad`` stays ``None`` and Adam
leaves them, as optax's zero update does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dair_pll_tpu import assets as jassets
from dair_pll_tpu.multibody import soa_terms as jterms
from dair_pll_tpu.ops import soa_solver as jsolver
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch.multibody import soa_terms as tterms
from dair_pll_tpu_torch.multibody.learnable_system import (
    DEFAULT_LOSS_IPM_ITERATIONS, DEFAULT_LOSS_NEWTON_ITERATIONS,
    DEFAULT_LOSS_WARM_BUDGET, LOSS_EPSILON,
    MultibodyLearnableSystem as TSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.ops import soa_kernels, soa_loss_kernels
from torch_parity import (DT, cube_transitions, icnn_transitions,
                          jax_params, params_numpy, perturbed_params)

TERMS_RTOL, TERMS_ATOL = 1e-11, 1e-13
LOSS_RTOL, LOSS_ATOL = 1e-8, 1e-12
FORCE_TOL = 1e-8
GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-10
PARAM_ATOL = 1e-8
LR = 1e-3
COLD_BUDGET = (DEFAULT_LOSS_IPM_ITERATIONS, DEFAULT_LOSS_NEWTON_ITERATIONS)
#: Leaves in the order of ``MultibodyParams.parameters()`` and JAX's
#: ``tree_leaves``.
LEAVES = ("theta", "friction", "hidden_weights[0]", "input_weights[0]",
          "input_weights[1]", "output_weight", "perturbations")


def _mesh_model():
    return jbuild({"cube": jassets.get_asset("cube_mesh")})


@functools.lru_cache(maxsize=None)
def _reference():
    """Inputs and the JAX training run: per step the loss, the gradients
    and the parameters after Adam; the cold step's per-sample loss,
    impulses, valid mask and state gradients; the seed; the first warm
    step's per-sample loss, refreshed cache and state gradients."""
    jmodel = _mesh_model()
    rng = np.random.default_rng(41)
    numpy_params = perturbed_params(
        rng, *params_numpy(jmodel.initial_params(jnp.float64)))
    x, x_plus = (np.concatenate(pair) for pair in zip(
        cube_transitions(rng, n=4), icnn_transitions(rng, numpy_params)))
    jx, jxp = jnp.asarray(x), jnp.asarray(x_plus)
    u = jnp.zeros((x.shape[0], 0))

    def cold(p, xx, xxp):
        loss = jterms.soa_contactnets_loss(
            jmodel, p, xx, u, xxp, DT, LOSS_EPSILON, *COLD_BUDGET,
            solver_backend="xla")
        return jnp.mean(loss), loss

    def warm(p, xx, xxp, cache, budget=DEFAULT_LOSS_WARM_BUDGET):
        loss, force, _ = jterms.soa_contactnets_loss_warm(
            jmodel, p, xx, u, xxp, DT, LOSS_EPSILON, *budget,
            [cache[i] for i in range(3)], solver_backend="xla")
        return jnp.mean(loss), (loss, jnp.stack(force))

    params = jax_params(numpy_params)
    optimizer = optax.adam(LR)
    state = optimizer.init(params)
    steps, record = [], {}
    with jax.disable_jit():
        sp = jterms.scalarize_derived(
            jmodel, jterms.derive_scalar_params(jmodel, params))
        M, Jc, phi, a_nc = jterms.soa_multibody_terms(
            jmodel, params, list(jxp.T[:7]), list(jxp.T[7:]), [])
        record["terms"] = jax.tree_util.tree_map(np.asarray,
                                                 (M, Jc, phi, a_nc))
        M, Jc, _, qc, _ = jterms.soa_loss_parts(
            jmodel, sp, list(jx.T[7:]), list(jxp.T[:7]), list(jxp.T[7:]),
            [], DT)
        force, valid = jsolver.solve_contact_impulse_soa(
            M, Jc, qc, jnp.asarray(LOSS_EPSILON), *COLD_BUDGET)
        record.update(force=np.asarray(jnp.stack(force)),
                      valid=np.asarray(valid).reshape(-1))
        for step in range(3):
            if step == 0:
                (loss, per_sample), grads = jax.value_and_grad(
                    cold, argnums=(0, 1, 2), has_aux=True)(params, jx, jxp)
                grads, gx, gxp = grads
                record.update(cold_loss=np.asarray(per_sample),
                              cold_gx=np.asarray(gx),
                              cold_gxp=np.asarray(gxp))
            elif step == 1:
                (loss, (per_sample, cache)), (grads, gx, gxp) = \
                    jax.value_and_grad(warm, argnums=(0, 1, 2),
                                       has_aux=True)(params, jx, jxp, cache)
                record.update(warm_loss=np.asarray(per_sample),
                              cache=np.asarray(cache), warm_gx=np.asarray(gx),
                              warm_gxp=np.asarray(gxp))
            else:
                (loss, (_, cache)), grads = jax.value_and_grad(
                    warm, has_aux=True)(params, jx, jxp, cache)
            updates, state = optimizer.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            steps.append({"loss": float(loss),
                          "grads": [np.asarray(g) for g in
                                    jax.tree_util.tree_leaves(grads)],
                          "params": [np.asarray(p) for p in
                                     jax.tree_util.tree_leaves(params)]})
            if step == 0:
                _, (_, cache) = warm(
                    params, jx, jxp,
                    jnp.zeros((3, jmodel.n_contacts, x.shape[0])),
                    COLD_BUDGET)
                record["seed"] = np.asarray(cache)
    return x, x_plus, numpy_params, steps, record


@functools.lru_cache(maxsize=None)
def _port():
    """The port's run on the CPU, as :func:`_reference`."""
    x, x_plus, numpy_params, _, _ = _reference()
    system = TSystem.from_urdfs({"cube": tassets.get_asset("cube_mesh")}, DT,
                                device="cpu")
    model = system.model
    params = params_from_numpy(model, *numpy_params)
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=LR)
    u = torch.zeros(x.shape[0], 0, dtype=torch.float64)
    record = {}
    with torch.no_grad():
        xt, xpt = torch.tensor(x), torch.tensor(x_plus)
        M, Jc, phi, a_nc = tterms.soa_multibody_terms(
            model, params, list(xpt.T[:7]), list(xpt.T[7:]), [])
        record["terms"] = (M, Jc, phi, a_nc)
        _, force, valid = tterms.soa_contactnets_loss(
            model, params, xt, u, xpt, DT, LOSS_EPSILON, *COLD_BUDGET)
        record.update(force=torch.stack(force).numpy(), valid=valid.numpy())
    steps = []
    cache = None
    for step in range(3):
        xt = torch.tensor(x, requires_grad=True)
        xpt = torch.tensor(x_plus, requires_grad=True)
        optimizer.zero_grad()
        if step == 0:
            loss = system.contactnets_loss_batch(params, xt, u, xpt,
                                                 use_fused=True)
        else:
            loss, cache = system.contactnets_loss_batch_warm(
                params, xt, u, xpt, cache)
        torch.mean(loss).backward()
        prefix = "cold" if step == 0 else "warm"
        if step < 2:
            record.update({f"{prefix}_loss": loss.detach().numpy(),
                           f"{prefix}_gx": xt.grad.numpy(),
                           f"{prefix}_gxp": xpt.grad.numpy()})
        if step == 1:
            record["cache"] = cache.numpy()
        grads = [np.zeros(tuple(leaf.shape)) if leaf.grad is None else
                 leaf.grad.numpy().copy() for leaf in leaves]
        record.setdefault("grad_is_none", []).append(
            [leaf.grad is None for leaf in leaves])
        optimizer.step()
        steps.append({"loss": float(torch.mean(loss.detach())),
                      "grads": grads,
                      "params": [leaf.detach().numpy().copy()
                                 for leaf in leaves]})
        if step == 0:
            with torch.no_grad():
                _, cache = system.contactnets_loss_batch_warm(
                    params, torch.tensor(x), u, torch.tensor(x_plus),
                    torch.zeros(3, model.n_contacts, x.shape[0],
                                dtype=torch.float64),
                    budget=COLD_BUDGET)
            record["seed"] = cache.numpy()
    return steps, record


def test_icnn_terms_match_jax():
    """Mass matrix, contact Jacobian, signed distances and the free
    acceleration of the ICNN cube at the observed next states."""
    _, _, _, _, ref = _reference()
    _, got = _port()
    for g, w in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), got["terms"])),
            jax.tree_util.tree_leaves(ref["terms"])):
        np.testing.assert_allclose(g, w, rtol=TERMS_RTOL, atol=TERMS_ATOL)
    # The box's transitions are deep in the ICNN; the ICNN's near contact.
    phi = np.min(ref["terms"][2], axis=0)
    assert np.all(phi[:8] < -0.1) and np.all(np.abs(phi[8:]) < 0.05)


def test_icnn_cold_loss_and_impulses_match_jax():
    _, _, _, _, ref = _reference()
    _, got = _port()
    np.testing.assert_allclose(got["cold_loss"], ref["cold_loss"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["force"], ref["force"], rtol=FORCE_TOL,
                               atol=FORCE_TOL)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert ref["valid"].all() and np.max(np.abs(ref["force"])) > 1e-3


def _assert_grads(got, want):
    for name, g, w in zip(LEAVES, got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("step", [0, 1])
def test_icnn_loss_gradients_match_jax(step):
    """Step 0: the cold loss; step 1: the first warm loss. The gradient
    of every leaf, of ``x`` and of ``x_plus``."""
    _, _, _, ref_steps, ref = _reference()
    steps, got = _port()
    _assert_grads(steps[step]["grads"], ref_steps[step]["grads"])
    prefix = "cold" if step == 0 else "warm"
    for key in ("gx", "gxp"):
        np.testing.assert_allclose(got[f"{prefix}_{key}"],
                                   ref[f"{prefix}_{key}"], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    # The weights' gradients are not zero; the perturbations' are, in
    # both (torch leaves them out of the graph).
    for g in ref_steps[step]["grads"][:-1]:
        assert np.max(np.abs(g)) > 0
    np.testing.assert_array_equal(ref_steps[step]["grads"][-1], 0.0)
    assert got["grad_is_none"][step] == [False] * 6 + [True]


def test_icnn_warm_loss_matches_jax():
    """The seed (the warm call from zeros at the cold budget) and the
    first warm step at (4, 10): per-sample loss and refreshed cache."""
    _, _, _, _, ref = _reference()
    _, got = _port()
    np.testing.assert_allclose(got["seed"], ref["seed"], rtol=FORCE_TOL,
                               atol=FORCE_TOL)
    np.testing.assert_allclose(got["warm_loss"], ref["warm_loss"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["cache"], ref["cache"], rtol=FORCE_TOL,
                               atol=FORCE_TOL)
    # The near-contact samples carry impulses.
    assert np.max(np.abs(ref["cache"][..., 8:])) > 1e-3


def test_icnn_adam_steps_match_optax():
    """Three Adam steps (cold, warm, warm): losses, the gradient of every
    leaf and every leaf after the step."""
    _, _, numpy_params, ref_steps, _ = _reference()
    steps, _ = _port()
    assert len(steps) == len(ref_steps) == 3
    for got, ref in zip(steps, ref_steps):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        _assert_grads(got["grads"], ref["grads"])
        for name, g, r in zip(LEAVES, got["params"], ref["params"]):
            np.testing.assert_allclose(g, r, rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
    # Adam moved every weight on the first step; the perturbations, whose
    # gradient is zero, stayed.
    start = jax.tree_util.tree_leaves(jax_params(numpy_params))
    for name, after, before in zip(LEAVES, steps[0]["params"], start):
        if name == "perturbations":
            np.testing.assert_array_equal(after, before)
        else:
            assert np.any(after != np.asarray(before)), name


class _Reached(Exception):
    """Raised by a stand-in wrapper to show the route reached it."""


@pytest.mark.parametrize("asset", ["cube", "cube_mesh"])
def test_loss_route_by_model_off_the_cpu(monkeypatch, asset):
    """On a device other than the CPU (the meta device stands in for the
    card), the box cube's cold and warm losses go to the loss kernels K1
    and K3, the ICNN cube's to the plain terms with the solve kernels K4
    and K5, and never to K1-K3."""
    reached = []

    def stand_in(name):
        def wrapper(*args, **kwargs):
            reached.append(name)
            raise _Reached(name)
        return wrapper

    for module, name, label in (
            (soa_loss_kernels, "fused_loss_fwd", "K1"),
            (soa_loss_kernels, "fused_loss_fwd_warm", "K3"),
            (soa_kernels, "solve_contact_impulse_soa_cuda_packed", "K4"),
            (soa_kernels, "solve_warm_hybrid_soa_cuda_packed", "K5")):
        monkeypatch.setattr(module, name, stand_in(label))
    system = TSystem.from_urdfs({"cube": tassets.get_asset(asset)}, DT,
                                device="meta")
    params = system.initial_params(torch.float32)
    x = torch.empty((4, 13), device="meta")
    u = torch.empty((4, 0), device="meta")
    with pytest.raises(_Reached):
        system.contactnets_loss_batch(params, x, u, x, use_fused=True)
    with pytest.raises(_Reached):
        system.contactnets_loss_batch_warm(
            params, x, u, x, torch.empty((3, 4, 4), device="meta"))
    assert reached == (["K1", "K3"] if asset == "cube" else ["K4", "K5"])


def test_default_mesh_model_trains_on_cpu():
    """``from_urdfs`` with the mesh asset builds the ICNN cube (the
    default representation), and a training step at a batch below
    ``FUSED_LOSS_MIN_BATCH`` with ``use_fused=True`` runs its cold solve
    through the cold solve's wrapper (the plain version on the CPU), never
    the loss kernels' wrappers, and moves every weight."""
    system = TSystem.from_urdfs({"cube": tassets.get_asset("cube_mesh")}, DT,
                                device="cpu")
    assert system.model.geometries[1].geom_type == "deep_support_convex"
    x, x_plus = cube_transitions(np.random.default_rng(3), n=2)
    params = system.initial_params(torch.float64)
    leaves = params.parameters()
    start = [leaf.detach().clone() for leaf in leaves]
    for leaf in leaves:
        leaf.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=LR)
    calls = []
    plain = soa_kernels.plain_packed_cold

    def counted(*args):
        calls.append(args[0].shape[-1])
        return plain(*args)

    def refuse(*args, **kwargs):
        raise AssertionError("the ICNN loss reached a loss kernel's wrapper")
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(soa_kernels, "plain_packed_cold", counted)
        for name in ("fused_loss_fwd", "fused_loss_fwd_warm",
                     "fused_loss_bwd"):
            patch.setattr(soa_loss_kernels, name, refuse)
        loss = torch.mean(system.contactnets_loss_batch(
            params, torch.tensor(x), torch.zeros(4, 0, dtype=torch.float64),
            torch.tensor(x_plus), use_fused=True))
        loss.backward()
    optimizer.step()
    assert calls == [4]
    assert bool(torch.isfinite(loss)) and float(loss.detach()) > 0
    for leaf, before in zip(leaves[:-1], start[:-1]):
        assert not torch.equal(leaf.detach(), before)
