"""The model-generic loss kernels' per-sample bodies (K1's
``model_loss_cold`` and K3's ``model_loss_warm`` in
``dair_pll_tpu_torch/csrc/model_terms.cuh``, K2's reverse-mode
``model_loss_vjp`` in ``csrc/model_adjoint.cuh``), compiled for the host
with ``g++`` by ``ops/host_adjoint.py`` through a stand-in
``cuda_runtime.h``, against their plain versions in float64 on the five
parity models of ``torch_parity.KERNEL_MODELS`` (the elbow in boxes and in
polygons, the polygon cube, ``pris2``, the actuated ``paddle``) and, in
the lane, gradient and counting tests, a box and a sphere on one body
(``torch_parity.SIZE_URDFS``; k = 5, on 5 lanes one contact a lane, the
free body's joint as constants) at perturbed parameters: the cold and warm loss within rtol 1e-12 (impulses
atol 1e-10: torch's CPU float64 square root is one ulp off on some
inputs, and a solve that has not converged carries that to some 1e-12;
equal valid masks), and K2's gradient, each sample's and the batch's,
within rtol 1e-10 (atol 1e-14) of torch autograd (``plain_loss_bwd``): at
the solved impulses, at random ones, and on edge cases (failed solves, a
witness at phi exactly 0, penetrating witnesses, contacts at rest, tied
support values). K1's and K3's bodies also as the card runs them, on k
lanes a sample (``HostModelTerms.loss(..., lanes=True)``: a thread a lane,
the lanes' sums over contacts exchanged through shared slots at a
barrier): equal bit for bit to the one-thread bodies, and to the plain
versions once those take their float64 square roots, sines and cosines
from the C library as the host build does (torch's vectorised CPU
functions round some 1% of square roots and 0.2% of sines differently;
on the card both sides use CUDA's). On the box cube, at the polygon cube's
size, the generic forward equals ``cube_terms.cuh``'s bit for bit and the
generic gradient ``cube_adjoint.cuh``'s within 1e-12. Last, the counting
build (``Counted``
in float32 and float64), which gives the generic kernels' rows their
bounds in ``chip_smoke.py``: its counts add up over samples and threads,
an invalid sample's gradient counts nothing, and K2's sweep counts fewer
operations than torch autograd's, the forward terms it recomputes counted
apart. The test computes nothing with JAX and skips without ``g++``.
"""
import contextlib
import functools
import math

import numpy as np
import pytest
import torch

from dair_pll_tpu_torch import assets
from dair_pll_tpu_torch.multibody.learnable_system import (
    CONTACT_FILTER_EPS, MultibodyLearnableSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.multibody.soa_terms import (
    derive_scalar_params, soa_forward_dynamics_batch, soa_rollout_qp)
from dair_pll_tpu_torch.ops import host_adjoint, soa_kernels
from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
from dair_pll_tpu_torch.urdf import build_multibody_model
from torch_parity import (COLD_BUDGET, DT, KERNEL_MODELS, LOSS_EPS,
                          SIZE_URDFS, WARM_BUDGET, kernel_model_urdfs,
                          kernel_transitions, size_model_urdfs,
                          size_transitions,
                          map_tree, perturbed_params)

LOSS_RTOL, FORCE_ATOL = 1e-12, 1e-10
GRAD_RTOL, GRAD_ATOL = 1e-10, 1e-14
#: The models of the lane and gradient tests: the parity models, and the
#: box and sphere body (``torch_parity.SIZE_URDFS``; witnesses 4 + 1, k =
#: 5), whose contacts split over lanes one a lane.
LANE_MODELS = (*sorted(KERNEL_MODELS), "box_sphere")


@pytest.fixture(scope="module")
def urdf_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("urdfs"))


@pytest.fixture(scope="module")
def host(tmp_path_factory, urdf_dir):
    """``model_terms.cuh`` built for the host
    (``host_adjoint.HostModelTerms``) at the sizes of the parity models,
    and K4/K5 at the cube's and the elbow's ``(n_v, k)``."""
    if host_adjoint.compiler() is None:
        pytest.skip("g++ is not installed: the host build needs it")
    return host_adjoint.HostModelTerms(
        str(tmp_path_factory.mktemp("model_terms")), model_sizes(urdf_dir),
        tuple(WARM_SHAPES.values()))


def model_sizes(urdf_dir: str) -> list:
    """The generic sizes (``soa_loss_kernels.model_size``) of the parity
    models and the box and sphere body."""
    return [lk.model_size(_inputs(name, urdf_dir)[0])
            for name in LANE_MODELS]


@functools.lru_cache(maxsize=None)
def _inputs(name: str, urdf_dir: str):
    """The port's model, a packed derived vector at perturbed parameters,
    batch-minor ``(xin, xp)`` (``xin`` with the actuation rows), the cold
    loss's plain impulses and valid mask with two samples failed, and a
    random cotangent."""
    if name in SIZE_URDFS:
        urdfs, representation = size_model_urdfs(name, urdf_dir)
    else:
        urdfs, representation = kernel_model_urdfs(name, urdf_dir, False)
    model = build_multibody_model(
        urdfs, **({} if representation is None else
                  {"mesh_representation": representation}))
    rng = np.random.default_rng(LANE_MODELS.index(name) + 7)
    if name in SIZE_URDFS:
        x, x_plus = size_transitions(model, rng)
        u = np.zeros((x.shape[0], 0))
    else:
        x, x_plus, u = kernel_transitions(name, model, rng)
    initial = MultibodyLearnableSystem(model, DT, device="cpu") \
        .initial_params(torch.float64)
    numpy_params = perturbed_params(
        rng, initial.theta.numpy(), initial.friction.numpy(),
        [map_tree(lambda t: t.numpy(), g) for g in initial.geometry])
    params = params_from_numpy(model, *numpy_params)
    pvec = lk.pack_derived(model, derive_scalar_params(model,
                                                       params)).detach()
    xin = torch.cat([torch.tensor(x).T, torch.tensor(u).T]).contiguous()
    xp = torch.tensor(x_plus).T.contiguous()
    _, force, valid = lk.plain_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                                        *COLD_BUDGET)
    valid = valid.clone()
    valid[[2, 11]] = False
    ct = torch.tensor(rng.uniform(0.5, 2.0, xin.shape[1]))
    return model, pvec, xin, xp, force, valid, ct


def _library(fn, x):
    return torch.tensor([fn(v) for v in x.detach().flatten().tolist()],
                        dtype=x.dtype).reshape(x.shape)


class _LibrarySin(torch.autograd.Function):
    """``sin`` from the C library, with torch's forward-mode rule (the
    plain terms take the kinematics' rates with ``torch.func.jvp``)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _library(math.sin, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, t):
        return t * _library(math.cos, ctx.saved_tensors[0])


class _LibraryCos(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _library(math.cos, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, t):
        return t * -_library(math.sin, ctx.saved_tensors[0])


@contextlib.contextmanager
def _library_math():
    """Float64 ``sqrt``, ``rsqrt`` (as 1 / sqrt), ``sin`` and ``cos`` from
    the C library, as the host build computes them, in place of torch's
    (``torch.*`` and the tensor methods) while the block runs."""
    library = {
        "sqrt": lambda x: torch.from_numpy(np.sqrt(x.detach().numpy())),
        "rsqrt": lambda x: torch.from_numpy(1.0 / np.sqrt(
            x.detach().numpy())),
        "sin": _LibrarySin.apply,
        "cos": _LibraryCos.apply}
    saved = [(owner, name, getattr(owner, name))
             for owner in (torch, torch.Tensor) for name in library]

    def routed(name, torch_fn):
        def fn(x, *args, **kwargs):
            if x.dtype == torch.float64 and not args and not kwargs:
                return library[name](x)
            return torch_fn(x, *args, **kwargs)
        return fn

    for owner, name, torch_fn in saved:
        setattr(owner, name, routed(name, torch_fn))
    try:
        yield
    finally:
        for owner, name, torch_fn in saved:
            setattr(owner, name, torch_fn)


def _assert_close(got, want, rtol, atol, what):
    err = (got - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), (
        f"{what}: max abs error {err.max().item():.3e}")


def _random_impulses(force, valid, seed):
    """Random impulses (normal rows nonnegative) of ``force``'s shape,
    every sample valid but the two the parity inputs fail."""
    rng = np.random.default_rng(seed)
    f = torch.tensor(rng.uniform(-1.0, 1.0, tuple(force.shape)))
    f[0] = f[0].abs()
    v = torch.ones_like(valid)
    v[[2, 11]] = False
    return f, v


def _assert_gradients(host, model, pvec, xin, xp, force, valid, ct,
                      samples=slice(None)):
    """K2's host sweep against ``plain_loss_bwd``: the batch's gradients
    and the derived-scalar gradient of each of ``samples`` (the plain
    version on a derived vector repeated per sample, whose gradient is per
    sample); exact zeros for failed solves and the configuration rows of
    ``xin``. Returns the sweep's ``(dp, dxin, dxp)``."""
    dp, dxin, dxp = host.vjp(model, pvec, xin, xp, force, valid, ct, DT)
    want = lk.plain_loss_bwd(model, pvec, xin, xp, force, valid, ct, DT,
                             LOSS_EPS)
    for what, got, ref in zip(("dp", "dxin", "dxp"),
                              (dp.sum(dim=0), dxin, dxp), want):
        _assert_close(got, ref, GRAD_RTOL, GRAD_ATOL, what)
    per_sample = pvec[:, None].expand(-1, xin.shape[1]).contiguous()
    ref = lk.plain_loss_bwd(model, per_sample, xin, xp, force, valid, ct,
                            DT, LOSS_EPS)[0].T
    _assert_close(dp[samples], ref[samples], GRAD_RTOL, GRAD_ATOL,
                  "dp per sample")
    assert not dp[~valid].any() and not dxin[:, ~valid].any()
    assert not dxp[:, ~valid].any() and not dxin[:model.n_q].any()
    assert dp[valid].abs().amax() > 0 and dxp[:, valid].abs().amax() > 0
    return dp, dxin, dxp


@pytest.mark.parametrize("kind", ["cold", "warm"])
@pytest.mark.parametrize("name", sorted(KERNEL_MODELS))
def test_loss_matches_plain_version(host, urdf_dir, name, kind):
    """K1's (cold) and K3's (warm, from the cold impulses) body against
    ``plain_loss_fwd`` and ``plain_loss_fwd_warm``."""
    model, pvec, xin, xp, force, _, _ = _inputs(name, urdf_dir)
    if kind == "cold":
        want = lk.plain_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                                 *COLD_BUDGET)
        got = host.loss(model, pvec, xin, xp, DT, LOSS_EPS, *COLD_BUDGET)
    else:
        want = lk.plain_loss_fwd_warm(model, pvec, xin, xp, force, DT,
                                      LOSS_EPS, *WARM_BUDGET)
        got = host.loss(model, pvec, xin, xp, DT, LOSS_EPS, *WARM_BUDGET,
                        fprev=force)
    _assert_close(got[0], want[0], LOSS_RTOL, 0.0, "loss")
    _assert_close(got[1], want[1], 0.0, FORCE_ATOL, "impulse")
    assert torch.equal(got[2], want[2]) and bool(want[2].all())
    assert want[1][0].amax(dim=0).gt(1e-6).float().mean() > 0.5


_LANE_INPUTS = {"parity": lambda name, urdf_dir: _inputs(name, urdf_dir),
                "edge": lambda name, urdf_dir: _edge_inputs(name, urdf_dir)}


def _lane_case(host, urdf_dir, name, inputs, kind):
    """``(model, pvec, xin, xp, budget, fprev)`` of one lane case: the
    parity or edge inputs, cold, or warm from their impulses."""
    model, pvec, xin, xp, force, _, _ = _LANE_INPUTS[inputs](name, urdf_dir)
    if kind == "cold":
        return model, pvec, xin, xp, COLD_BUDGET, None
    return model, pvec, xin, xp, WARM_BUDGET, force


@pytest.mark.parametrize("inputs", sorted(_LANE_INPUTS))
@pytest.mark.parametrize("kind", ["cold", "warm"])
@pytest.mark.parametrize("name", LANE_MODELS)
def test_lane_bodies_match_plain_bit_for_bit(host, urdf_dir, name, kind,
                                             inputs):
    """K1's and K3's bodies on k lanes a sample, as the card's kernels run
    them, against ``plain_loss_fwd`` and ``plain_loss_fwd_warm`` with the
    C library's float64 square roots, sines and cosines: the loss, the
    impulses and the valid mask bit for bit, on the parity inputs and on
    the edge cases (phi exactly 0, penetration, rest, ties across the
    sort's cut; warm from random impulses)."""
    model, pvec, xin, xp, budget, fprev = _lane_case(host, urdf_dir, name,
                                                     inputs, kind)
    got = host.loss(model, pvec, xin, xp, DT, LOSS_EPS, *budget,
                    fprev=fprev, lanes=model.n_contacts)
    with _library_math():
        if fprev is None:
            want = lk.plain_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                                     *budget)
        else:
            want = lk.plain_loss_fwd_warm(model, pvec, xin, xp, fprev, DT,
                                          LOSS_EPS, *budget)
    for what, a, b in zip(("loss", "impulse", "valid"), got, want):
        assert torch.equal(a, b), (
            f"{what}: max abs difference "
            f"{(a.double() - b.double()).abs().max().item():.3e}")
    assert want[1].abs().max() > 0


@pytest.mark.parametrize("name", LANE_MODELS)
def test_lane_bodies_equal_one_thread_bodies(host, urdf_dir, name):
    """The same bodies on one thread a sample (L = 1), on k lanes (L = k)
    and on the card's lanes at the model's size (``fwd_lanes``) give the
    same bits on the same inputs: cold and warm, parity and edge
    inputs."""
    model = _inputs(name, urdf_dir)[0]
    counts = sorted({model.n_contacts, host.fwd_lanes(model)} - {1})
    assert counts and all(model.n_contacts % n == 0 for n in counts)
    for inputs in sorted(_LANE_INPUTS):
        for kind in ("cold", "warm"):
            model, pvec, xin, xp, budget, fprev = _lane_case(
                host, urdf_dir, name, inputs, kind)
            one = host.loss(model, pvec, xin, xp, DT, LOSS_EPS, *budget,
                            fprev=fprev)
            for lanes in counts:
                got = host.loss(model, pvec, xin, xp, DT, LOSS_EPS, *budget,
                                fprev=fprev, lanes=lanes)
                for a, b in zip(one, got):
                    assert torch.equal(a, b), (name, inputs, kind, lanes)


@pytest.mark.parametrize("name", LANE_MODELS)
def test_gradient_matches_plain_backward(host, urdf_dir, name):
    """K2's reverse-mode body at the cold solve's impulses: four samples'
    derived-scalar gradients, the batch's, and the state gradients against
    torch autograd; a failed solve's sample, and the configuration rows of
    ``xin``, get exactly 0. (Sample 12 of ``paddle`` holds an entry, 7.7e-4
    in a row up to 36, that cancels: the sweep, and the forward-mode K2
    before it, sit 1.0e-13 from autograd's rounding of it.)"""
    _assert_gradients(host, *_inputs(name, urdf_dir), samples=[0, 5, 9, 15])


@pytest.mark.parametrize("name", LANE_MODELS)
def test_gradient_at_random_impulses(host, urdf_dir, name):
    """As above at random impulses: every contact's rows carry a
    cotangent, whatever the solve made of it."""
    model, pvec, xin, xp, force, valid, ct = _inputs(name, urdf_dir)
    force, valid = _random_impulses(force, valid, 3)
    _assert_gradients(host, model, pvec, xin, xp, force, valid, ct)


@functools.lru_cache(maxsize=None)
def _edge_inputs(name: str, urdf_dir: str):
    """Transitions at the sweep's branches, at random impulses. The base
    stands upright at the origin, so that each of its witnesses has phi =
    (vertex height) + (base height) exactly: sample 0 rests (zero next
    velocity, every contact's sliding rate 0) just above the ground, 1
    touches it with its lowest witness at phi exactly 0, 2 and 3 penetrate
    it; 4 is a recipe sample, 5 a failed solve. A box's bottom corners tie
    in the sort; a polygon's derived vertices are set so that five of the
    base's eight tie in height, across the sort's cut at four witnesses."""
    model, pvec, xin, xp, _, _, ct = _inputs(name, urdf_dir)
    xin, xp, ct = xin[:, :6].clone(), xp[:, :6].clone(), ct[:6]
    pvec = pvec.clone()
    base = model.geometries[model.collision_candidates[0][1]]
    if base.geom_type == "polygon":
        start = lk._shape_indices(model)[model.collision_candidates[0][1]]
        z = pvec[start + 2:start + 3 * len(base.vertices_init):3]  # a view
        order = torch.argsort(z)
        z[order[:5]] = z[order[:4]].mean()
    xp[:4, :4] = torch.tensor([1.0, 0.0, 0.0, 0.0])[:, None]
    xp[4:7, :4] = 0.0
    xp[model.n_q:, 0] = 0.0
    phi = lk._parts(model, pvec, xin, xp, DT)[2]
    lowest = phi[:base.n_query, :4].amin(dim=0)
    xp[6, :4] = -lowest + torch.tensor([1e-3, 0.0, -3e-3, -1e-2])
    force = torch.tensor(np.random.default_rng(5).uniform(
        0.0, 1.0, (3, model.n_contacts, 6)))
    force[1:] -= 0.5
    valid = torch.tensor([True] * 5 + [False])
    return model, pvec, xin, xp, force, valid, ct


@pytest.mark.parametrize("name", LANE_MODELS)
def test_gradient_at_edge_cases(host, urdf_dir, name):
    """K2's reverse-mode body on ``_edge_inputs``: the branches of |phi| at
    0, of clamp_min(-phi, 0) on penetration, of the safe sliding norm at
    rest, and of the sort's tie order, against torch autograd."""
    model, pvec, xin, xp, force, valid, ct = _edge_inputs(name, urdf_dir)
    M, Jc, phi, qc, dv = lk._parts(model, pvec, xin, xp, DT)
    assert bool((phi[:, 1] == 0).any()) and bool((phi[:, 2:4] < 0).any())
    sliding = [sum(Jc[i][v][:, 0] * xp[model.n_q + v, 0]
                   for v in range(model.n_v)) for i in (1, 2)]
    assert float((sliding[0] ** 2 + sliding[1] ** 2).max()) < 1e-24
    _assert_gradients(host, model, pvec, xin, xp, force, valid, ct)


#: Relative bar of the sweep with the free body's joint as constants
#: against the one that reads it from the descriptor.
DESC_BODY_RTOL = 1e-12


@pytest.mark.parametrize("inputs", ["solved", "random", "edge"])
def test_gradient_equals_descriptor_sweep(host, urdf_dir, inputs):
    """K2's sweep at the box and sphere body's size, which takes the free
    body's joint as compile-time constants (``kConstFreeBody``), against
    the sweep that reads it from the descriptor (the design before the
    constants, ``HostModelTerms.vjp_desc_body``), each sample's
    derived-scalar gradient and the state gradients within rtol
    DESC_BODY_RTOL: at the cold solve's impulses, at random impulses and
    on ``_edge_inputs``."""
    if inputs == "edge":
        model, pvec, xin, xp, force, valid, ct = _edge_inputs("box_sphere",
                                                              urdf_dir)
    else:
        model, pvec, xin, xp, force, valid, ct = _inputs("box_sphere",
                                                         urdf_dir)
        if inputs == "random":
            force, valid = _random_impulses(force, valid, 3)
    got = host.vjp(model, pvec, xin, xp, force, valid, ct, DT)
    want = host.vjp_desc_body(model, pvec, xin, xp, force, valid, ct, DT)
    for what, a, b in zip(("dp", "dxin", "dxp"), got, want):
        _assert_close(a, b, DESC_BODY_RTOL, 0.0, what)
    assert got[0].abs().amax() > 0
    elbow = _inputs("elbow", urdf_dir)
    with pytest.raises(ValueError, match="descriptor already"):
        host.vjp_desc_body(*elbow[:4], *elbow[4:6], elbow[6], DT)


@pytest.mark.parametrize("kind", ["cold", "warm"])
def test_generic_forward_equals_cube_header_on_the_box_cube(host, kind):
    """The box cube at the generic size ``(1, 7, 6, 1, 4)``: the generic
    terms, solve and assembly give the box cube's kernels' results
    (``cube_terms.cuh``) bit for bit."""
    model = build_multibody_model({"cube": assets.get_asset("cube")})
    assert lk.cube_cover(model) and lk.generic_cover(model)
    rng = np.random.default_rng(4)
    x, x_plus, _ = kernel_transitions("cube_polygon", model, rng)
    params = MultibodyLearnableSystem(model, DT, device="cpu") \
        .initial_params(torch.float64)
    pvec = lk.pack_derived(model, derive_scalar_params(model,
                                                       params)).detach()
    xin, xp = torch.tensor(x).T.contiguous(), torch.tensor(x_plus).T \
        .contiguous()
    fprev = None
    budget = COLD_BUDGET
    if kind == "warm":
        fprev = host.cube_loss(pvec, xin, xp, DT, LOSS_EPS, *COLD_BUDGET)[1]
        budget = WARM_BUDGET
    generic = host.loss(model, pvec, xin, xp, DT, LOSS_EPS, *budget,
                        fprev=fprev)
    cube = host.cube_loss(pvec, xin, xp, DT, LOSS_EPS, *budget, fprev=fprev)
    for got, want in zip(generic, cube):
        assert torch.equal(got, want)
    assert cube[1].abs().max() > 0


def test_generic_gradient_equals_cube_adjoint_on_the_box_cube(host):
    """The box cube at the generic size ``(1, 7, 6, 1, 4)``: the generic
    reverse-mode sweep gives the box cube's K2 (``cube_adjoint.cuh``'s
    ``cube_loss_vjp``) within 1e-12 (1 + |cube|), at solved impulses with
    two failed samples: the evidence for routing the box cube to the
    generic kernels."""
    model = build_multibody_model({"cube": assets.get_asset("cube")})
    rng = np.random.default_rng(8)
    x, x_plus, _ = kernel_transitions("cube_polygon", model, rng)
    params = MultibodyLearnableSystem(model, DT, device="cpu") \
        .initial_params(torch.float64)
    pvec = lk.pack_derived(model, derive_scalar_params(model,
                                                       params)).detach()
    xin, xp = torch.tensor(x).T.contiguous(), torch.tensor(x_plus).T \
        .contiguous()
    _, force, valid = host.cube_loss(pvec, xin, xp, DT, LOSS_EPS,
                                     *COLD_BUDGET)
    valid[[1, 6]] = False
    ct = torch.tensor(rng.uniform(0.5, 2.0, xin.shape[1]))
    generic = host.vjp(model, pvec, xin, xp, force, valid, ct, DT)
    cube = host.cube_vjp(pvec, xin, xp, force, valid, ct, DT)
    for got, want in zip(generic, cube):
        assert bool(((got - want).abs() <= 1e-12 * (1 + want.abs())).all())
    assert cube[0].abs().max() > 0 and cube[2].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_operation_counts_add_up(host, urdf_dir, dtype):
    """The counted bodies on the elbow, in ``dtype``'s arithmetic: each
    kind counts work, structural operations are a share of what runs,
    counts add up over threads and (for K2) over samples, a failed
    sample's gradient counts nothing, and K2's reverse-mode sweep needs
    fewer operations than torch autograd's (``plain_loss_bwd``). The
    forward terms the sweep computes a second time are counted apart
    (``recomputed``): none in the loss bodies, in K2 fewer than the cold
    loss's own forward needs, and not in K2's ``needed``."""
    _assert_counts_add_up(host, urdf_dir, "elbow", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_operation_counts_add_up_at_uneven_contacts(host, urdf_dir, dtype):
    """As above on the box and sphere body (k = 5, witnesses 4 + 1), whose
    bodies take the free body's joint as constants and whose cold solve
    leaves its loops at their exact fixed points (counted as skipped):
    the same counts' rules."""
    _assert_counts_add_up(host, urdf_dir, "box_sphere", dtype)


def _assert_counts_add_up(host, urdf_dir, name, dtype):
    """The rules of ``test_operation_counts_add_up`` on ``name``."""
    model, pvec, xin, xp, force, valid, ct = _inputs(name, urdf_dir)
    args = [t.to(dtype) for t in (pvec, xin, xp)]
    f = force.to(dtype)
    for kind, fin in (("cold", None), ("warm", f), ("vjp", f)):
        whole = host.count(kind, model, *args, fin, valid, ct.to(dtype), DT,
                           LOSS_EPS, *(WARM_BUDGET if kind == "warm" else
                                       COLD_BUDGET))
        assert 0 < whole["needed"] < whole["executed"], kind
        assert (whole["recomputed"] > 0) == (kind == "vjp"), kind
        if kind == "cold":
            cold = whole
        threaded = host.count(kind, model, *args, fin, valid, ct.to(dtype),
                              DT, LOSS_EPS, *COLD_BUDGET, threads=3) \
            if kind != "warm" else whole
        assert threaded == whole, kind
    per_sample = [host.count("vjp", model, args[0], args[1][:, b:b + 1],
                             args[2][:, b:b + 1], f[..., b:b + 1],
                             valid[b:b + 1], ct[b:b + 1].to(dtype), DT,
                             LOSS_EPS, *COLD_BUDGET)
                  for b in range(xin.shape[1])]
    assert sum(c["needed"] for c in per_sample) == whole["needed"]
    assert sum(c["executed"] for c in per_sample) == whole["executed"]
    assert sum(c["recomputed"] for c in per_sample) == whole["recomputed"]
    assert all(c["needed"] == c["executed"] == c["recomputed"] == 0
               for c, ok in zip(per_sample, valid) if not ok)
    assert whole["recomputed"] < cold["needed"]
    assert whole["needed"] + whole["recomputed"] <= whole["executed"]
    autograd = host_adjoint.count_torch_operations(lambda: lk.plain_loss_bwd(
        model, *args, f, valid, ct.to(dtype), DT, LOSS_EPS))
    assert whole["needed"] < autograd


#: K5's rollout QPs: the fused rollouts' budget and regularization, and a
#: batch that leaves the last block's groups past its end.
ROLLOUT_BUDGET, ROLLOUT_EPS, QP_B = (14, 6), 1e-4, 37
#: K5's sizes, (n_v, k): the box cube's and the elbow's.
WARM_SHAPES = {"cube": (6, 4), "elbow": (7, 8)}


@functools.lru_cache(maxsize=None)
def _rollout_qps(name: str):
    """Packed float64 QPs ``(m, jc, qc, w0)`` of the fused rollout of the
    box cube (``name`` ``cube``, at (6, 4)) or the elbow (at (7, 8)): the
    solve of step 4 from states near the ground, with the primal carried
    from step 3, as the rollout hands K5 its QPs."""
    system = MultibodyLearnableSystem.from_urdfs(
        {name: assets.get_asset(name)}, DT, device="cpu")
    params = system.initial_params(torch.float64)
    rng = np.random.default_rng(21)
    x0 = torch.tensor(
        assets.cube_states_near_ground(rng, QP_B) if name == "cube" else
        assets.tree_states_near_ground(rng, QP_B, system.model))
    traj = system.simulate_batch(params, x0, 4, use_fused=True)
    with torch.no_grad():
        _, w_carry = soa_forward_dynamics_batch(
            system.model, params, traj[:, 3],
            torch.zeros_like(traj[:, 0, :system.model.n_v]), DT,
            ROLLOUT_EPS, CONTACT_FILTER_EPS, *ROLLOUT_BUDGET)
        m, jc, qc, _, _ = soa_rollout_qp(system.model, params, traj[:, 4],
                                         DT)
    assert tuple(jc.shape[1:3]) == WARM_SHAPES[name]
    return m, jc, qc, w_carry.T.contiguous()


@pytest.mark.parametrize("name", sorted(WARM_SHAPES))
def test_warm_solve_lanes_match_plain_bit_for_bit(host, name):
    """K5 at the cube's (6, 4) and the elbow's (7, 8) on the card's lanes a
    QP (``warm_lanes``, a thread a lane, the last groups past the batch)
    against ``soa_kernels.plain_packed`` with the C library's float64
    square roots, on the rollout's QPs at its budget: impulses, primal and
    valid mask bit for bit."""
    qps = _rollout_qps(name)
    n_v, k = WARM_SHAPES[name]
    lanes = host.warm_lanes((n_v, k))
    assert lanes > 1 and k % lanes == 0
    got = host.warm_solve(*qps, ROLLOUT_EPS, *ROLLOUT_BUDGET, lanes=lanes,
                          groups=QP_B + 11)
    with _library_math():
        want = soa_kernels.plain_packed(*qps, ROLLOUT_EPS, *ROLLOUT_BUDGET)
    for what, a, b in zip(("force", "w", "valid"), got, want):
        assert torch.equal(a, b), (
            f"{what}: max abs difference "
            f"{(a.double() - b.double()).abs().max().item():.3e}")
    assert want[0][0].amax(dim=0).gt(1e-6).float().mean() > 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(WARM_SHAPES))
def test_warm_solve_lanes_equal_one_thread(host, name, dtype):
    """K5 at (6, 4) and (7, 8) on the card's lanes a QP gives the
    one-thread body's bits (``warm_solve_packed`` at L = 1, the old
    kernels' code), in ``dtype``: with exactly the batch's groups and with
    the last groups past its end, which must write nothing."""
    qps = [t.to(dtype) for t in _rollout_qps(name)]
    one = host.warm_solve(*qps, ROLLOUT_EPS, *ROLLOUT_BUDGET)
    for groups in (QP_B, QP_B + 11):
        got = host.warm_solve(*qps, ROLLOUT_EPS, *ROLLOUT_BUDGET,
                              lanes=host.warm_lanes(WARM_SHAPES[name]),
                              groups=groups)
        for a, b in zip(one, got):
            assert torch.equal(a, b), (dtype, groups)
    assert one[0].dtype == dtype and bool(one[2].any())


def _cube_inputs():
    """The box cube at its initial parameters: the packed derived vector
    and 16 batch-minor float64 transitions (``kernel_transitions``)."""
    model = build_multibody_model({"cube": assets.get_asset("cube")})
    x, x_plus, _ = kernel_transitions("cube_polygon", model,
                                      np.random.default_rng(4))
    params = MultibodyLearnableSystem(model, DT, device="cpu") \
        .initial_params(torch.float64)
    pvec = lk.pack_derived(model, derive_scalar_params(model,
                                                       params)).detach()
    return (model, pvec, torch.tensor(x).T.contiguous(),
            torch.tensor(x_plus).T.contiguous())


def test_cube_warm_body_matches_plain_bit_for_bit(host):
    """The box cube's K3 as the card runs it (``cube_terms.cuh``'s
    ``cube_loss_warm``, one thread a sample) from K1's impulses, and K1
    (``cube_loss_cold``), against ``plain_loss_fwd_warm`` and
    ``plain_loss_fwd`` with the C library's float64 square roots: the
    loss, the impulses and the valid mask bit for bit."""
    model, pvec, xin, xp = _cube_inputs()
    cold = host.cube_loss(pvec, xin, xp, DT, LOSS_EPS, *COLD_BUDGET)
    warm = host.cube_loss(pvec, xin, xp, DT, LOSS_EPS, *WARM_BUDGET,
                          fprev=cold[1])
    with _library_math():
        want = (lk.plain_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                                  *COLD_BUDGET),
                lk.plain_loss_fwd_warm(model, pvec, xin, xp, cold[1], DT,
                                       LOSS_EPS, *WARM_BUDGET))
    for got, ref in zip((cold, warm), want):
        for what, a, b in zip(("loss", "impulse", "valid"), got, ref):
            assert torch.equal(a, b), (
                f"{what}: max abs difference "
                f"{(a.double() - b.double()).abs().max().item():.3e}")
    assert warm[1].abs().max() > 0 and bool(warm[2].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cube_operation_counts(host, dtype):
    """The box cube's K1 and K3 bodies (``cube_terms.cuh``) counted on
    ``Counted`` in ``dtype``'s arithmetic, the counts their rows' bounds
    take in ``chip_smoke.py``: positive, ``needed`` at most ``executed``,
    the same on a second run and on three threads, and K3's warm (4, 10)
    solve below K1's cold (10, 10)."""
    _, pvec, xin, xp = _cube_inputs()
    fprev = host.cube_loss(pvec, xin, xp, DT, LOSS_EPS, *COLD_BUDGET)[1]
    args = [t.to(dtype) for t in (pvec, xin, xp)]
    counts = {}
    for kind, fin, budget in (("cold", None, COLD_BUDGET),
                              ("warm", fprev.to(dtype), WARM_BUDGET)):
        c = host.cube_count(kind, *args, fin, DT, LOSS_EPS, *budget)
        assert 0 < c["needed"] <= c["executed"], kind
        assert host.cube_count(kind, *args, fin, DT, LOSS_EPS, *budget) == c
        assert host.cube_count(kind, *args, fin, DT, LOSS_EPS, *budget,
                               threads=3) == c
        counts[kind] = c
    assert counts["warm"]["needed"] < counts["cold"]["needed"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(WARM_SHAPES))
def test_warm_solve_operation_counts(host, name, dtype):
    """K5's body at (6, 4) and (7, 8) (``warm_solve_packed``) counted on
    ``Counted`` in ``dtype``'s arithmetic, the count its rows' bounds take
    in ``chip_smoke.py``, on the rollout's QPs: positive, ``needed`` at
    most ``executed``, the same on a second run and on three threads, and
    below the plain version's count (torch's dense algebra)."""
    qps = [t.to(dtype) for t in _rollout_qps(name)]
    c = host.warm_solve_count(*qps, ROLLOUT_EPS, *ROLLOUT_BUDGET)
    assert 0 < c["needed"] <= c["executed"]
    assert host.warm_solve_count(*qps, ROLLOUT_EPS, *ROLLOUT_BUDGET) == c
    assert host.warm_solve_count(*qps, ROLLOUT_EPS, *ROLLOUT_BUDGET,
                                 threads=3) == c
    plain = host_adjoint.count_torch_operations(
        lambda: soa_kernels.plain_packed(*qps, ROLLOUT_EPS, *ROLLOUT_BUDGET))
    assert c["needed"] < plain


#: K4's budget and regularization on the rollout's QPs: the cold loss's.
COLD_QP_BUDGET, COLD_QP_EPS = (10, 10), 1e-3


def _cold_qps(name: str, dtype):
    """K4's packed QPs ``(m, jc, qc)`` at ``name``'s size in ``dtype``: the
    rollout's QPs (``_rollout_qps``), then two that reach the solve's
    exits: a contact Jacobian of zeros with the contacts separating (qc =
    (0.5, 0, 0)), whose IPM freezes and whose SAP-Newton iterate w = 0 is
    a fixed point from the start, and the same with qc = 0 (a Newton fixed
    point whose IPM does not freeze in float64); last two whose solve is
    not finite (a NaN and an infinity in qc)."""
    m, jc, qc, _ = _rollout_qps(name)
    jc_x, qc_x = jc[..., :4].clone(), qc[..., :4].clone()
    jc_x[..., :2] = 0
    qc_x[..., :2] = 0
    qc_x[0, :, 0] = 0.5
    qc_x[0, 0, 2] = float("nan")
    qc_x[1, 0, 3] = float("inf")
    return tuple(torch.cat((a, b), dim=-1).to(dtype).contiguous()
                 for a, b in ((m, m[:, :4]), (jc, jc_x), (qc, qc_x)))


@pytest.mark.parametrize("name", sorted(WARM_SHAPES))
def test_cold_solve_lanes_match_plain_bit_for_bit(host, name):
    """K4 at the cube's (6, 4) and the elbow's (7, 8) on the card's lanes a
    QP (``cold_lanes``, a thread a lane, the last groups past the batch),
    its loops' fixed-point exits on, against
    ``soa_kernels.plain_packed_cold`` with the C library's float64 square
    roots, on the rollout's QPs and on QPs that reach each exit or fail:
    impulses and valid mask bit for bit."""
    qps = _cold_qps(name, torch.float64)
    lanes = host.cold_lanes(WARM_SHAPES[name])
    assert lanes > 1 and WARM_SHAPES[name][1] % lanes == 0
    got = host.cold_solve(*qps, COLD_QP_EPS, *COLD_QP_BUDGET, lanes=lanes,
                          groups=qps[0].shape[-1] + 11)
    with _library_math():
        want = soa_kernels.plain_packed_cold(*qps, COLD_QP_EPS,
                                             *COLD_QP_BUDGET)
    for what, a, b in zip(("force", "valid"), got, want):
        assert torch.equal(a, b), (
            f"{what}: max abs difference "
            f"{(a.double() - b.double()).abs().max().item():.3e}")
    assert want[0].amax(dim=(0, 1)).gt(1e-6).float().mean() > 0.5
    assert not bool(want[1][-2:].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(WARM_SHAPES))
def test_cold_solve_lanes_equal_one_thread(host, name, dtype):
    """K4 at (6, 4) and (7, 8) on the card's lanes a QP (4, and at (6, 4)
    also the 2 of its large float64 batches) gives the one-thread body's
    bits (``cold_solve_packed`` at L = 1), in ``dtype``, with the exits on
    and with the exits on lanes against the one thread without them: with
    exactly the batch's groups and with the last groups past its end,
    which must write nothing."""
    qps = _cold_qps(name, dtype)
    n = qps[0].shape[-1]
    lanes = [host.cold_lanes(WARM_SHAPES[name])] + [2] * (name == "cube")
    one = host.cold_solve(*qps, COLD_QP_EPS, *COLD_QP_BUDGET)
    plain_loops = host.cold_solve(*qps, COLD_QP_EPS, *COLD_QP_BUDGET,
                                  exits=False)
    for width in lanes:
        for groups in (n, n + 11):
            got = host.cold_solve(*qps, COLD_QP_EPS, *COLD_QP_BUDGET,
                                  lanes=width, groups=groups)
            for a, b, c in zip(one, got, plain_loops):
                assert torch.equal(a, b) and torch.equal(a, c), (
                    dtype, width, groups)
    assert one[0].dtype == dtype and bool(one[1].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(WARM_SHAPES))
def test_cold_solve_exits_keep_bits(host, name, dtype):
    """K4's exits leave its IPM and SAP-Newton loops at exact fixed points:
    with them on and off the body gives the same bits on every QP, on one
    thread and on lanes; the constructed QPs reach both exits (an IPM that
    freezes, a Newton iterate that repeats its bits), and a QP whose solve
    is not finite never leaves SAP-Newton early (its iterate is NaN)."""
    qps = _cold_qps(name, dtype)
    n = qps[0].shape[-1]

    def count(cols, exits=True):
        return host.cold_solve_count(*(t[..., cols] for t in qps),
                                     COLD_QP_EPS, *COLD_QP_BUDGET,
                                     exits=exits)

    lanes = host.cold_lanes(WARM_SHAPES[name])
    for kw in ({}, {"lanes": lanes}):
        on = host.cold_solve(*qps, COLD_QP_EPS, *COLD_QP_BUDGET, **kw)
        off = host.cold_solve(*qps, COLD_QP_EPS, *COLD_QP_BUDGET,
                              exits=False, **kw)
        assert all(torch.equal(a, b) for a, b in zip(on, off)), kw
    frozen, fixed = count(slice(n - 4, n - 3)), count(slice(n - 3, n - 2))
    assert frozen["ipm_fixed"] > 0 and frozen["newton_fixed"] > 0
    assert fixed["newton_fixed"] == COLD_QP_BUDGET[1]
    for b in (n - 2, n - 1):
        assert count(slice(b, b + 1))["newton_fixed"] == 0, b
    assert count(slice(0, n))["needed"] < count(slice(0, n), False)["needed"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(WARM_SHAPES))
def test_cold_solve_operation_counts(host, name, dtype):
    """K4's body at (6, 4) and (7, 8) (``cold_solve_packed``) counted on
    ``Counted`` in ``dtype``'s arithmetic, the count its rows' bounds take
    in ``chip_smoke.py``, with both loops' exits, SAP-Newton's alone (the
    card's float32 kernel) and none: positive, ``needed`` at most
    ``executed``, the same on a second run and on three threads (the fixed
    points too), fewer with more exits, and below the plain version's
    count."""
    qps = tuple(t[..., :QP_B] for t in _cold_qps(name, dtype))
    args = (COLD_QP_EPS, *COLD_QP_BUDGET)
    counts = {}
    for exits in (True, "newton", False):
        c = host.cold_solve_count(*qps, *args, exits=exits)
        assert 0 < c["needed"] <= c["executed"]
        assert host.cold_solve_count(*qps, *args, exits=exits) == c
        assert host.cold_solve_count(*qps, *args, threads=3,
                                     exits=exits) == c
        counts[exits] = c
    assert counts[False]["ipm_fixed"] == counts[False]["newton_fixed"] == 0
    assert counts["newton"]["ipm_fixed"] == 0
    assert counts[True]["ipm_fixed"] > 0
    assert counts[True]["needed"] <= counts["newton"]["needed"] \
        <= counts[False]["needed"]
    assert counts[True]["needed"] < counts[False]["needed"]
    plain = host_adjoint.count_torch_operations(
        lambda: soa_kernels.plain_packed_cold(*qps, *args))
    assert counts[False]["needed"] < plain


def test_cube_cold_body_exits_keep_bits(host):
    """The box cube's K1 body (``cube_loss_cold``) with its solve's exits
    on (as K1 runs it) and off gives the same bits, equal to
    ``plain_loss_fwd`` with the C library's float64 square roots, on the
    parity transitions and on the same lifted 1 m off the ground, which
    reach both exits in float64 (an IPM that freezes, a Newton iterate
    that repeats its bits)."""
    model, pvec, xin, xp = _cube_inputs()
    lifted = torch.zeros_like(xin)
    lifted[6] = 1.0
    xin, xp = torch.cat((xin, xin + lifted), 1), torch.cat((xp, xp + lifted),
                                                           1)
    on = host.cube_loss(pvec, xin, xp, DT, LOSS_EPS, *COLD_BUDGET)
    off = host.cube_loss(pvec, xin, xp, DT, LOSS_EPS, *COLD_BUDGET,
                         exits=False)
    with _library_math():
        want = lk.plain_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                                 *COLD_BUDGET)
    for what, a, b, c in zip(("loss", "impulse", "valid"), on, off, want):
        assert torch.equal(a, b) and torch.equal(a, c), what
    c = host.cube_count("cold", pvec, xin, xp, None, DT, LOSS_EPS,
                        *COLD_BUDGET)
    assert c["ipm_fixed"] > 0 and c["newton_fixed"] > 0
    assert c["needed"] < host.cube_count(
        "cold", pvec, xin, xp, None, DT, LOSS_EPS, *COLD_BUDGET,
        exits=False)["needed"]
