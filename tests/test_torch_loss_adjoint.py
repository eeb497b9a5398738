"""The reverse-mode body of the ContactNets loss backward kernel K2
(``cube_loss_vjp`` in ``dair_pll_tpu_torch/csrc/cube_adjoint.cuh``),
compiled for the host with ``g++`` and held against its plain version,
``soa_loss_kernels.plain_loss_bwd`` (torch autograd of the terms and the
assembly), in float64 within 1e-9 (1 + |plain|) on every output: the
parameter gradient of each sample and of the batch, and the state
gradients. Then the count of the operations the sweep needs
(``host_adjoint``'s counting scalar, K2's bound on the card): the counted
sweep computes the same gradients bit for bit, and the count is that of
each sample, summed.

``host_adjoint``'s stand-in ``cuda_runtime.h`` turns the CUDA qualifiers
into plain C++, so the device code compiles unchanged. The inputs are the parity tests' cube
transitions (``torch_parity.cube_transitions``) and samples that reach the
adjoint's special branches: invalid samples, a contact at rest (the safe
sliding norm), witness keys tied at the sort's cut (a cube balanced on an
edge) and large angular velocities (the Coriolis terms). The test skips
without ``g++``; it uses no JAX.
"""
import functools

import numpy as np
import pytest
import torch

from dair_pll_tpu_torch import assets
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.ops import host_adjoint
from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
from torch_parity import DT, cube_transitions

TOL = 1e-9
LOSS_EPS = 1e-3


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``cube_loss_vjp`` built for the host (``host_adjoint.HostAdjoint``)."""
    if host_adjoint.compiler() is None:
        pytest.skip("g++ is not installed: the adjoint's host build needs it")
    return host_adjoint.HostAdjoint(str(tmp_path_factory.mktemp("adjoint")))


def _derived(halves):
    """A packed derived vector (``pack_derived``'s layout) with an
    off-centre mass and a full inertia, so that every term has a
    gradient: pi (10), the plane's and the box's friction, halves."""
    mass, com = 0.37, np.array([0.004, -0.003, 0.002])
    inertia = [6.8e-4, 7.1e-4, 6.5e-4, 2e-5, -1e-5, 3e-5]
    return torch.tensor([mass, *(mass * com), *inertia, 0.15, 0.9, *halves],
                        dtype=torch.float64)


#: Packed derived vectors: unequal half lengths route each half's
#: gradient to its own axis; the cube's equal ones let witness keys tie.
PVECS = {"box": _derived([0.0524, 0.0510, 0.0540]),
         "cube": _derived([0.0524] * 3)}


@functools.lru_cache(maxsize=None)
def _transitions():
    """``(x, x_plus)`` ``(n, 13)`` float64: the parity recipe, then the
    special samples. Computed once; callers do not write to them."""
    rng = np.random.default_rng(5)
    x, x_plus = cube_transitions(rng)
    # Large angular velocities (the Coriolis terms): 25 rad/s about random
    # axes on the recipe's first four.
    spin = rng.standard_normal((4, 3))
    x_plus[:4, 7:10] = 25.0 * spin / np.linalg.norm(spin, axis=-1,
                                                    keepdims=True)
    edge = np.sqrt(0.5)
    special = np.array([
        # At rest: zero velocity, so every contact's sliding rate is 0.
        [1.0, 0.0, 0.0, 0.0, 0.01, -0.02, 0.05, *[0.0] * 6],
        # Axis-aligned, slightly penetrating: the bottom corners tie.
        [1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.05, 0.3, -0.2, 0.1, 0.1, 0.2, -0.3],
        # Balanced on an edge: four corners tie at the sort's cut, so the
        # sort's tie order picks two of them.
        [edge, 0.5, -0.5, 0.0, 0.0, 0.0, 0.07, 0.2, 0.1, -0.4, 0.0, 0.1, 0.2],
        # The same, spinning fast about the edge.
        [edge, 0.5, -0.5, 0.0, 0.0, 0.0, 0.07, 18.0, -18.0, 0.0, 0.0, 0.0,
         -0.1]])
    x_special = special.copy()
    x_special[:, 7:] += 0.05 * rng.standard_normal((4, 6))
    return (torch.tensor(np.concatenate([x, x_special])),
            torch.tensor(np.concatenate([x_plus, special])))


@pytest.fixture(scope="module")
def model():
    return MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, DT, device="cpu").model


def _inputs(model, pvec, impulse):
    """Batch-minor ``(xin, xp, force, valid, ct)``: the cold solve's
    impulses and valid mask, or random impulses; two samples forced
    invalid either way."""
    x, x_plus = _transitions()
    xin, xp = x.T.contiguous(), x_plus.T.contiguous()
    B = xin.shape[1]
    rng = np.random.default_rng(9)
    _, force, valid = lk.plain_loss_fwd(model, pvec, xin, xp, DT, LOSS_EPS,
                                        10, 10)
    if impulse == "random":
        force = torch.tensor(rng.uniform(-1.0, 1.0, (3, 4, B)))
        force[0] = force[0].abs()
        valid = torch.ones(B, dtype=torch.bool)
    valid = valid.clone()
    valid[[3, 12]] = False
    ct = torch.tensor(rng.uniform(0.5, 2.0, B))
    return xin, xp, force.contiguous(), valid, ct


def _close(got, ref):
    return bool(((got - ref).abs() <= TOL * (1 + ref.abs())).all())


@pytest.mark.parametrize("impulse", ["solved", "random"])
@pytest.mark.parametrize("params", sorted(PVECS))
def test_adjoint_matches_plain_backward(host, model, params, impulse):
    """Batch gradient, each sample's parameter gradient and the state
    gradients of ``cube_loss_vjp`` against torch autograd."""
    pvec = PVECS[params]
    xin, xp, force, valid, ct = _inputs(model, pvec, impulse)
    dp, dxin, dxp = host.vjp(pvec, xin, xp, force, valid, ct, DT)
    ref = lk.plain_loss_bwd(model, pvec, xin, xp, force, valid, ct, DT,
                            LOSS_EPS)
    for name, got, want in zip(("dp", "dxin", "dxp"),
                               (dp.sum(dim=0), dxin, dxp), ref):
        assert _close(got, want), (
            f"{name}: max abs error {(got - want).abs().max().item():.3e}")
    for b in range(xin.shape[1]):
        cols = slice(b, b + 1)
        want = lk.plain_loss_bwd(model, pvec, xin[:, cols], xp[:, cols],
                                 force[..., cols], valid[cols], ct[cols],
                                 DT, LOSS_EPS)[0]
        assert _close(dp[b], want), (b, (dp[b] - want).abs().max().item())
    # A failed solve contributes exactly 0, the configuration rows of x
    # get exactly 0, and the gradients do not vanish elsewhere.
    assert not dp[~valid].any() and not dxin[:, ~valid].any()
    assert not dxp[:, ~valid].any() and not dxin[:7].any()
    assert dxp[:, valid].abs().amax(dim=1)[[0, 1, 2, 3, 6]].min() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_operation_count_follows_the_sweep(host, model, dtype):
    """The counted sweep runs the arithmetic of ``dtype`` (float64: the
    same gradients as ``cube_loss_vjp<double>``, bit for bit); its counts
    add up over samples and threads, an invalid sample counts nothing, and
    the structural zeros and ones the count skips are a share of what
    runs."""
    pvec = PVECS["box"]
    xin, xp, force, valid, ct = _inputs(model, pvec, "solved")
    args = [t.to(dtype) for t in (pvec, xin, xp, force)]
    whole = host.count(*args, valid, ct.to(dtype), DT, gradients=True)
    if dtype == torch.float64:
        for got, want in zip(whole["gradients"],
                             host.vjp(pvec, xin, xp, force, valid, ct, DT)):
            assert torch.equal(got, want)
    assert whole["valid"] == int(valid.sum())
    assert 0 < whole["needed"] < whole["executed"]
    assert host.count(*args, valid, ct.to(dtype), DT, threads=3) == {
        k: whole[k] for k in ("needed", "executed", "valid")}
    per_sample = [host.count(args[0], *(t[..., b:b + 1] for t in args[1:]),
                             valid[b:b + 1], ct[b:b + 1].to(dtype), DT)
                  for b in range(xin.shape[1])]
    assert sum(c["needed"] for c in per_sample) == whole["needed"]
    assert sum(c["executed"] for c in per_sample) == whole["executed"]
    assert all(c["needed"] == c["executed"] == 0
               for c, ok in zip(per_sample, valid) if not ok)
