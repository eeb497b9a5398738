"""Every model size the TPU kernels take, on the port's kernels' plain
versions and host builds, against the JAX package in float64.

The models beyond the five of ``torch_parity.KERNEL_MODELS``
(``torch_parity.SIZE_URDFS``): a ball (one sphere; (n_v, k) = (6, 1)), a
box and a sphere on one body (witnesses 4 + 1, (6, 5)), a pentagonal
prism of 10 vertices as a polygon, and three box cubes (k = 15, the K6
route). On the card each size's kernels build at first use; here:

* the fused cold loss through the training entry point and its plain
  impulses against JAX's ``soa_contactnets_loss`` steps (run eagerly, as
  ``tests/test_torch_elbow_loss.py`` runs them): loss rtol 1e-9, atol
  1e-12, impulses atol 1e-8;
* the K4/K5 wrappers (their plain versions on CPU tensors) against the
  TPU kernels in interpret mode on rollout QPs at (6, 1) and (6, 5), atol
  1e-8 (``tests/test_torch_elbow_rollout.py``'s bar);
* K6's plain version against ``solve_cone_qp_pallas`` in interpret mode
  at k = 15 on the three cubes' loss QPs and on random problems, rtol and
  atol 1e-11 (``tests/test_torch_vmapped_solvers.py``'s bar);
* the ``g++`` host build of ``csrc/model_terms.cuh``,
  ``csrc/model_adjoint.cuh`` and ``csrc/hybrid_solve.cuh``
  (``ops/host_adjoint.HostModelTerms``) at the new sizes against the
  plain versions: the cold and warm loss (rtol 1e-12, impulses atol
  1e-10), K2's gradient (rtol 1e-10, atol 1e-14) and K5/K4 (atol 1e-9:
  torch's CPU square roots differ from the C library's by an ulp on some
  inputs). It skips without ``g++``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu.ops.pallas_cone_solver import solve_cone_qp_pallas
from dair_pll_tpu.ops.soa_pallas import (solve_contact_impulse_soa_pallas,
                                         solve_warm_hybrid_soa_pallas)
from dair_pll_tpu_torch import assets
from dair_pll_tpu_torch.multibody import soa_terms as tterms
from dair_pll_tpu_torch.multibody.learnable_system import (
    DYNAMICS_EPSILON, MultibodyLearnableSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.multibody.soa_terms import (derive_scalar_params,
                                                    soa_rollout_qp)
from dair_pll_tpu_torch.ops import cone_kernels, host_adjoint, soa_kernels
from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
from dair_pll_tpu_torch.urdf import build_multibody_model
from torch_parity import (COLD_BUDGET, DT, LOSS_EPS, WARM_BUDGET,
                          size_case, size_model_urdfs)

LOSS_RTOL, LOSS_ATOL, FORCE_TOL = 1e-9, 1e-12, 1e-8
SOLVE_TOL = 1e-8
K6_RTOL = 1e-11
HOST_LOSS_RTOL, HOST_FORCE_ATOL = 1e-12, 1e-10
GRAD_RTOL, GRAD_ATOL = 1e-10, 1e-14
HOST_SOLVE_ATOL = 1e-9
QP_B = 32
FUSED = ("ball", "box_sphere", "prism10")
#: Each fused model's size: its name, (n_v, k) and lanes a QP of K4/K5.
SIZES = {"ball": ("b1_q7_v6_k1_w1", (6, 1)),
         "box_sphere": ("b1_q7_v6_k5_w4_1", (6, 5)),
         "prism10": ("b1_q7_v6_k4_n10", (6, 4))}


@pytest.fixture(scope="module")
def urdf_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("size_urdfs"))


def _model(name, urdf_dir):
    urdfs, representation = size_model_urdfs(name, urdf_dir)
    return build_multibody_model(
        urdfs, **({} if representation is None else
                  {"mesh_representation": representation}))


@pytest.mark.parametrize("name", FUSED)
def test_cold_loss_and_impulses_match_jax(urdf_dir, name):
    """The fused cold loss and its plain impulses match JAX's at
    perturbed parameters; the model's size is covered (its name, its
    solve shape) and the transitions reach contact."""
    _, tmodel, (x, x_plus, u), numpy_params, ref = size_case(name, urdf_dir)
    assert lk.generic_size(tmodel) == SIZES[name][0]
    assert (tmodel.n_v, tmodel.n_contacts) == SIZES[name][1]
    system = MultibodyLearnableSystem(tmodel, DT, device="cpu")
    params = params_from_numpy(tmodel, *numpy_params)
    x, x_plus, u = (torch.tensor(a) for a in (x, x_plus, u))
    with torch.no_grad():
        loss = system.contactnets_loss_batch(params, x, u, x_plus,
                                             use_fused=True)
        _, force, valid = tterms.soa_contactnets_loss(
            tmodel, params, x, u, x_plus, DT, LOSS_EPS, *COLD_BUDGET)
    np.testing.assert_allclose(loss.numpy(), ref["loss"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(torch.stack(force).numpy(), ref["force"],
                               rtol=FORCE_TOL, atol=FORCE_TOL)
    np.testing.assert_array_equal(valid.numpy(), ref["valid"])
    assert np.all(ref["valid"]) and np.max(ref["force"][0]) > 1e-4


def _rollout_qps(name, urdf_dir):
    """Packed rollout QPs ``(m, jc, qc, w0)`` of a fused model, float64:
    the solve of step 3 from states near the ground, a random primal."""
    system = MultibodyLearnableSystem(_model(name, urdf_dir), DT,
                                      device="cpu")
    params = system.initial_params(torch.float64)
    x0 = torch.tensor(assets.tree_states_near_ground(
        np.random.default_rng(61), QP_B, system.model))
    traj = system.simulate_batch(params, x0, 3, use_fused=True)
    with torch.no_grad():
        m, jc, qc, _, _ = soa_rollout_qp(system.model, params,
                                         traj[:, 2].contiguous(), DT)
    w0 = torch.tensor(np.random.default_rng(62).normal(
        0.0, 0.05, (system.model.n_v, QP_B)))
    return m, jc, qc, w0


def _jax_qp(m, jc, qc):
    n_v = jc.shape[1]
    M = [[jnp.asarray(m[i * n_v + j].numpy()) for j in range(n_v)]
         for i in range(n_v)]
    Jc = [[jnp.asarray(jc[i, v].numpy()) for v in range(n_v)]
          for i in range(3)]
    return M, Jc, [jnp.asarray(qc[i].numpy()) for i in range(3)]


@pytest.mark.parametrize("kernel,name", [("K5", "ball"),
                                         ("K5", "box_sphere"),
                                         ("K4", "ball")])
def test_solve_wrappers_match_tpu_kernels(urdf_dir, kernel, name):
    """K5 (warm, the rollout budget (14, 6) at eps 1e-4) at the ball's
    (6, 1) and the box and sphere body's (6, 5), and K4 (cold, (10, 10)
    at eps 1e-3) at (6, 1): the wrappers on CPU tensors against the TPU
    kernels in interpret mode, which read their sizes from their inputs;
    no launch is counted."""
    m, jc, qc, w0 = _rollout_qps(name, urdf_dir)
    assert tuple(jc.shape[1:3]) == SIZES[name][1]
    M, Jc, q = _jax_qp(m, jc, qc)
    counter = (soa_kernels.solve_warm_hybrid_soa_cuda if kernel == "K5"
               else soa_kernels.solve_contact_impulse_soa_cuda)
    soa_kernels.reset_launches(counter)
    if kernel == "K5":
        force, w, valid = soa_kernels.solve_warm_hybrid_soa_cuda_packed(
            m, jc, qc, w0, DYNAMICS_EPSILON, 14, 6)
        j_force, j_w, j_valid = solve_warm_hybrid_soa_pallas(
            M, Jc, q, [jnp.asarray(row.numpy()) for row in w0],
            DYNAMICS_EPSILON, 14, 6, block=QP_B, interpret=True)
        np.testing.assert_allclose(w.numpy(), np.stack(
            [np.asarray(row).reshape(-1) for row in j_w]), rtol=0,
            atol=SOLVE_TOL)
    else:
        force, valid = soa_kernels.solve_contact_impulse_soa_cuda_packed(
            m, jc, qc, 1e-3, 10, 10)
        j_force, j_valid = solve_contact_impulse_soa_pallas(
            M, Jc, q, 1e-3, 10, 10, block=QP_B, interpret=True)
    j_force = np.stack([np.asarray(f) for f in j_force])
    np.testing.assert_allclose(force.numpy(), j_force, rtol=0, atol=SOLVE_TOL)
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(j_valid).reshape(-1))
    assert np.all(np.asarray(j_valid)) and np.max(j_force[0]) > 1e-3
    assert counter.launches == 0


def _three_cube_qps(urdf_dir, n=4):
    """``(Q, q)`` of the three cubes' vmapped loss at ``n`` transitions
    (the cubes 0.12 m apart near the ground), as the K6 route hands them
    to the kernel: ``Q = D + eps I`` and ``q``, float64."""
    model = _model("three_cubes", urdf_dir)
    system = MultibodyLearnableSystem(model, DT, device="cpu")
    rng = np.random.default_rng(63)
    x = np.zeros((n, model.n_q + model.n_v))
    for body in range(3):
        q0, v0 = model.body_q_offset(body), model.body_v_offset(body)
        quat = rng.standard_normal((n, 4))
        x[:, q0:q0 + 4] = quat / np.linalg.norm(quat, axis=-1,
                                                keepdims=True)
        x[:, q0 + 4] = 0.12 * (body - 1)
        x[:, q0 + 6] = 0.06 + 0.02 * rng.random(n)
        x[:, model.n_q + v0:model.n_q + v0 + 6] = \
            0.5 * rng.standard_normal((n, 6))
    x = torch.tensor(x)
    x_plus = x + 0.005 * torch.tensor(rng.standard_normal(x.shape))
    with torch.no_grad():
        delassus, q_vec, _, _, _, _ = system._contactnets_qp(
            system.initial_params(torch.float64), x,
            x.new_zeros((n, 0)), x_plus)
    Q = delassus + LOSS_EPS * torch.eye(delassus.shape[-1],
                                        dtype=torch.float64)
    return Q.contiguous(), q_vec.contiguous()


@pytest.mark.parametrize("problems", ["three_cubes", "random"])
def test_k6_plain_version_matches_the_tpu_kernel_at_k15(urdf_dir, problems):
    """K6's plain version against ``solve_cone_qp_pallas(Q, q, 200,
    True)`` at k = 15 (45 rows: two 32-row blocks a problem, summed as
    the kernel's lanes sum them): the three cubes' loss QPs, and random
    PSD problems of the JAX package's recipe; the wrapper's check takes
    the size."""
    if problems == "three_cubes":
        Q, q = _three_cube_qps(urdf_dir)
    else:
        rng = np.random.default_rng(15)
        A = rng.standard_normal((4, 45, 45))
        Q = torch.tensor(A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(45))
        q = torch.tensor(rng.standard_normal((4, 45)) * 2)
    assert cone_kernels._check(Q, q) == (Q.shape[0], 15)
    want = np.asarray(solve_cone_qp_pallas(jnp.asarray(Q.numpy()),
                                           jnp.asarray(q.numpy()), 200,
                                           True))
    got = cone_kernels.plain_apgd(Q, q, 200).numpy()
    np.testing.assert_allclose(got, want, rtol=K6_RTOL, atol=K6_RTOL)
    assert np.max(np.abs(want)) > 1e-3


@pytest.fixture(scope="module")
def host(urdf_dir):
    """The host build at the new sizes, and K4/K5 at (6, 1) and (6, 5)."""
    if host_adjoint.compiler() is None:
        pytest.skip("g++ is not installed: the host build needs it")
    return host_adjoint.HostModelTerms(
        f"{urdf_dir}/host", sizes=[lk.model_size(_model(name, urdf_dir))
                                   for name in FUSED],
        shapes=((6, 1), (6, 5)))


def _packed(name, urdf_dir):
    _, tmodel, (x, x_plus, u), numpy_params, _ = size_case(name, urdf_dir)
    params = params_from_numpy(tmodel, *numpy_params)
    pvec = lk.pack_derived(tmodel, derive_scalar_params(tmodel,
                                                        params)).detach()
    xin = torch.tensor(np.concatenate([x, u], axis=-1)).T.contiguous()
    return tmodel, pvec, xin, torch.tensor(x_plus).T.contiguous()


@pytest.mark.parametrize("name", FUSED)
def test_host_loss_matches_plain(host, urdf_dir, name):
    """K1's and K3's bodies (``model_loss_cold``, ``model_loss_warm``,
    one thread a sample) at the model's own size against the plain
    versions: loss, impulses, valid masks."""
    model, pvec, xin, xp = _packed(name, urdf_dir)
    cold = lk.plain_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                             *COLD_BUDGET)
    got = host.loss(model, pvec, xin, xp, DT, LOSS_EPS, *COLD_BUDGET)
    warm = lk.plain_loss_fwd_warm(model, pvec, xin, xp, cold[1], DT,
                                  LOSS_EPS, *WARM_BUDGET)
    got_warm = host.loss(model, pvec, xin, xp, DT, LOSS_EPS, *WARM_BUDGET,
                         fprev=cold[1])
    for a, b in ((got, cold), (got_warm, warm)):
        np.testing.assert_allclose(a[0].numpy(), b[0].numpy(),
                                   rtol=HOST_LOSS_RTOL, atol=0)
        np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=0,
                                   atol=HOST_FORCE_ATOL)
        assert torch.equal(a[2], b[2])
    assert bool(cold[2].all()) and float(cold[1][0].max()) > 1e-4


@pytest.mark.parametrize("name", FUSED)
def test_host_gradient_matches_plain(host, urdf_dir, name):
    """K2's reverse-mode sweep at the model's own size (a sphere's
    radius and the support direction's cotangent; mixed witness counts;
    10 vertices) against torch autograd of the plain assembly."""
    model, pvec, xin, xp = _packed(name, urdf_dir)
    _, force, valid = lk.plain_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                                        *COLD_BUDGET)
    ct = torch.tensor(np.random.default_rng(64).uniform(0.5, 2.0,
                                                        xin.shape[1]))
    dp, dxin, dxp = host.vjp(model, pvec, xin, xp, force, valid, ct, DT)
    want = lk.plain_loss_bwd(model, pvec, xin, xp, force, valid, ct, DT,
                             LOSS_EPS)
    for got, ref in zip((dp.sum(dim=0), dxin, dxp), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert float(want[0].abs().max()) > 0


@pytest.mark.parametrize("kernel,name", [("K5", "ball"),
                                         ("K5", "box_sphere"),
                                         ("K4", "ball")])
def test_host_solves_match_plain(host, urdf_dir, kernel, name):
    """K5's and K4's bodies at (6, 1) and (6, 5), one thread a QP as the
    card runs them there (``kWarmLanes``, ``kColdLanes``: odd k), against
    ``plain_packed`` and ``plain_packed_cold``."""
    m, jc, qc, w0 = _rollout_qps(name, urdf_dir)
    shape = tuple(jc.shape[1:3])
    if kernel == "K5":
        assert host.warm_lanes(shape) == 1
        got = host.warm_solve(m, jc, qc, w0, DYNAMICS_EPSILON, 14, 6)
        want = soa_kernels.plain_packed(m, jc, qc, w0, DYNAMICS_EPSILON,
                                        14, 6)
    else:
        assert host.cold_lanes(shape) == 1
        got = host.cold_solve(m, jc, qc, 1e-3, 10, 10)
        want = soa_kernels.plain_packed_cold(m, jc, qc, 1e-3, 10, 10)
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=HOST_SOLVE_ATOL)
    assert torch.equal(got[-1], want[-1])


DIVERGENCE_STATES = 8192
#: ``chip_smoke.py``'s ``SIZE_DIVERGED_SHARE``.
DIVERGED_SHARE = 230 / 8192
#: Standard deviations of the difference of two counts that the port's
#: count of diverged trajectories may lie above the reference's.
DIVERGED_SIGMAS = 3.0


@pytest.mark.slow
@pytest.mark.parametrize("name", ["ball", "box_sphere"])
def test_float32_divergence_is_the_references(urdf_dir, name):
    """A fused float32 rollout of 128 steps (``chip_smoke.py``'s
    ``size_cover`` length) from all DIVERGENCE_STATES of ``chip_smoke.py``'s
    states of the model (``tree_states_near_ground``, seed 20 or 21), in
    the port and in JAX on the CPU, JAX run op by op
    (``jax.disable_jit``): each of its operations then rounds on its own,
    as the port's do, where XLA's compiled CPU code fuses products and sums
    into FMAs. The float32 divergence is chaotic and mostly on different
    trajectories, and its share moves with that rounding (printed: JAX
    compiled beside op by op). So the port's count may lie at most DIVERGED_SIGMAS standard
    deviations of the difference of two counts (``sqrt(port + JAX)``)
    above the reference's, and within DIVERGED_SHARE, of which this is the
    witness; each trajectory that leaves the finite numbers in either
    stays finite in float64 in the port. Prints the counts (``-s``); some
    20 minutes a model."""
    import jax
    from dair_pll_tpu.multibody.learnable_system import (
        MultibodyLearnableSystem as JSystem)
    from dair_pll_tpu.urdf import build_multibody_model as jbuild
    steps = 128
    urdfs, _ = size_model_urdfs(name, urdf_dir)
    system = MultibodyLearnableSystem(build_multibody_model(urdfs), DT,
                                      device="cpu")
    seed = 20 if name == "ball" else 21
    x0 = assets.tree_states_near_ground(np.random.default_rng(seed), 8192,
                                        system.model)[:DIVERGENCE_STATES]
    port = system.simulate_batch(system.initial_params(torch.float32),
                                 torch.tensor(x0, dtype=torch.float32),
                                 steps, use_fused=True).numpy()
    jsystem = JSystem(jbuild(urdfs), DT)
    args = (jsystem.model.initial_params(jnp.float32),
            jnp.asarray(x0, dtype=jnp.float32))
    with jax.disable_jit():
        ref = np.asarray(jsystem.simulate_batch(*args, steps,
                                                use_fused=True))
    compiled = np.asarray(jax.jit(lambda p, x: jsystem.simulate_batch(
        p, x, steps, use_fused=True))(*args))
    assert port.dtype == ref.dtype == np.float32
    port_out, ref_out, compiled_out = (
        np.nonzero(~np.isfinite(t).all(axis=(1, 2)))[0]
        for t in (port, ref, compiled))
    print(f"float32 {name} trajectories not finite over {steps} steps, of "
          f"{DIVERGENCE_STATES}: port {len(port_out)}, JAX op by op "
          f"{len(ref_out)} ({len(np.intersect1d(port_out, ref_out))} of "
          f"them the port's), JAX compiled {len(compiled_out)}")
    allowance = DIVERGED_SIGMAS * np.sqrt(len(port_out) + len(ref_out))
    assert len(port_out) <= len(ref_out) + allowance, (port_out, ref_out)
    assert len(port_out) <= DIVERGED_SHARE * DIVERGENCE_STATES, port_out
    either = np.union1d(port_out, ref_out)
    if len(either):
        referee = system.simulate_batch(system.initial_params(torch.float64),
                                        torch.tensor(x0[either]), steps,
                                        use_fused=True)
        assert bool(torch.isfinite(referee).all())
