"""Gradients of the port's fused ContactNets loss for the generic loss
kernels' models against the JAX package's, float64: for the elbow box (the
cold loss and the warm loss, warm-started from the cold impulses) and the
elbow polygon (cold), every parameter leaf's gradient, and the gradients
with respect to ``x`` and ``x_plus``, through the loss kernels' entry on
CPU tensors (the plain K1 or K3 forward and the plain K2 backward), match
``jax.grad`` of JAX's loss at its own detached impulses (rtol 1e-6, atol
1e-9, the bar of ``tests/test_fused_kernel.py``); so do the per-sample
losses (rtol 1e-9) and the warm impulses (atol 1e-8).
``test_torch_model_terms_host.py`` holds the gradients of the other parity
models (the polygon cube, ``pris2``, the actuated ``paddle``) against the
port's plain version. The JAX side runs eagerly (``jax.disable_jit``), as
in ``test_torch_loss.py``; inputs are ``torch_parity.kernel_case``'s.
"""
import jax
import numpy as np
import pytest
import torch

from dair_pll_tpu_torch.ops import soa_kernels
from dair_pll_tpu_torch.ops import soa_loss_kernels as lk
from torch_parity import (COLD_BUDGET as COLD, DT, LOSS_EPS as EPS,
                          WARM_BUDGET as WARM, kernel_case, kernel_gradients,
                          kernel_port)

LOSS_RTOL, LOSS_ATOL = 1e-9, 1e-12
FORCE_TOL = 1e-8
GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-9
#: Models whose gradients this file holds against JAX, and which losses.
GRADIENT_CASES = [("elbow", "cold"), ("elbow", "warm"),
                  ("elbow_polygon", "cold")]


@pytest.fixture(scope="module")
def urdf_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("urdfs"))


@pytest.mark.parametrize("name,kind", GRADIENT_CASES)
def test_gradients_through_kernel_entry_match_jax(urdf_dir, name, kind):
    """The loss kernels' entry on CPU tensors (the plain K1 or K3 forward,
    the plain K2 backward): per-sample loss, refreshed impulses (warm) and
    the gradient of every parameter leaf, of ``x`` and of ``x_plus``
    match ``jax.grad``; no kernel is launched."""
    _, _, _, _, ref = kernel_case(name, urdf_dir)
    j_loss, (jp, jx, jxp) = kernel_gradients(name, kind, urdf_dir)
    system, params, x, x_plus, u = kernel_port(name, urdf_dir)
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    x.requires_grad_(True)
    x_plus.requires_grad_(True)
    wrappers = (lk.fused_loss_fwd, lk.fused_loss_fwd_warm, lk.fused_loss_bwd)
    for wrapper in wrappers:
        soa_kernels.reset_launches(wrapper)
    args = (system.model, params, x, u, x_plus, DT, EPS)
    if kind == "cold":
        loss = lk.fused_contactnets_loss_kernel(*args, *COLD)
    else:
        loss, force = lk.fused_contactnets_loss_kernel_warm(
            *args, *WARM, torch.tensor(ref["force"]))
        np.testing.assert_allclose(force.numpy(), ref["warm_force"],
                                   rtol=FORCE_TOL, atol=FORCE_TOL)
    torch.sum(loss).backward()
    np.testing.assert_allclose(loss.detach().numpy(), j_loss,
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    expected = [jp.theta, jp.friction,
                *jax.tree_util.tree_leaves(jp.geometry)]
    assert len(leaves) == len(expected)
    for leaf, want in zip(leaves, expected):
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), jx, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(x_plus.grad.numpy(), jxp, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert [w.launches for w in wrappers] == [0, 0, 0]
