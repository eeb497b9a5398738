"""K6's reductions on lane groups, pinned on the CPU.

The APGD cone solve kernel (``dair_pll_tpu_torch/csrc/apgd_cone_solve.cu``)
runs a problem of n = 3k rows on a group of G lanes of a warp, G the
smallest of 8, 16 and 32 that holds n, and sums over the group by a
butterfly of width G (``__shfl_xor_sync(mask, v, offset, G)`` from G/2
down). Its plain version sums as a 32-lane butterfly does
(``cone_kernels._warp_sum``: zeros to 32 lanes, halves added pairwise).
Here a torch model of the width-G butterfly, lane for lane, equals that sum
bit for bit for every n <= G, on inputs with signed zeros, subnormals,
large magnitudes, infinities and NaNs, save the sign of a sum of zeros,
which no use of the sum sees; and ``plain_apgd`` with the group butterfly
in place of the 32-lane one gives the same bits. Last, the wrapper's
routes: CPU tensors run the plain version; k = 0 (the check a CUDA call
goes through), mixed devices and another device raise.
Uses no JAX and builds nothing.
"""
import numpy as np
import pytest
import torch

from dair_pll_tpu_torch.ops import cone_kernels

GROUPS = (8, 16, 32)


def group_lanes(n: int) -> int:
    """The kernel's group width for n rows (``kGroupLanes``)."""
    return next(g for g in GROUPS if n <= g)


def group_butterfly(v: torch.Tensor, width: int) -> torch.Tensor:
    """The width-``width`` butterfly of ``v (..., n)``, zeros in lanes n..:
    every lane's sum, ``(..., width)``: at each step lane i adds lane
    ``i ^ offset``'s value to its own, as ``v + __shfl_xor_sync(...)``."""
    v = torch.nn.functional.pad(v, (0, width - v.shape[-1]))
    lanes = torch.arange(width)
    offset = width // 2
    while offset:
        v = v + v[..., lanes ^ offset]
        offset //= 2
    return v


def same_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: equal values with equal signs, or both NaN."""
    return ((a == b) & (torch.signbit(a) == torch.signbit(b))) | (
        torch.isnan(a) & torch.isnan(b))


def special_rows(n: int, dtype: torch.dtype) -> torch.Tensor:
    """Rows of n values: random at several scales, with signed zeros,
    subnormals, values near the largest finite one (whose sums overflow),
    infinities of either sign and NaNs mixed in."""
    rng = np.random.default_rng(n)
    info = torch.finfo(dtype)
    pool = np.array([0.0, -0.0, float(info.tiny) / 4, -float(info.tiny) / 8,
                     float(info.tiny), float(info.max) / 2,
                     -float(info.max) / 3, np.inf, -np.inf, np.nan, 1.0,
                     -1.0])
    rows = [rng.standard_normal(n) * scale
            for scale in (1e-30, 1e-3, 1.0, 1e3, 1e30)]
    rows += [rng.choice(pool, n) for _ in range(200)]
    rows += [np.where(rng.random(n) < 0.5, rng.choice(pool, n),
                      rng.standard_normal(n)) for _ in range(200)]
    rows += [np.zeros(n), -np.zeros(n), np.where(np.arange(n) % 2, 0.0, -0.0)]
    return torch.tensor(np.array(rows), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", GROUPS)
def test_group_butterfly_equals_the_warp_sum(width, dtype):
    """For every n <= G: the same sum in every lane of the group, and that
    sum the plain version's 32-lane sum bit for bit, but where both are
    zero (then possibly of other signs)."""
    for n in range(1, width + 1):
        rows = special_rows(n, dtype)
        lanes = group_butterfly(rows, width)
        assert bool(same_bits(lanes, lanes[..., :1]).all()), n
        got, want = lanes[..., 0], cone_kernels._warp_sum(rows)
        zero = (got == 0) & (want == 0)
        assert bool((same_bits(got, want) | zero).all()), (
            n, rows[~(same_bits(got, want) | zero)][:3])
        assert bool(torch.isnan(got).any()) and bool(torch.isinf(got).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", GROUPS)
def test_all_zero_sums_pass_the_same_tests(width, dtype):
    """A vector of zeros of mixed signs: the group's and the warp's sums
    are zeros, perhaps of other signs, that give the same results in every
    use the kernel makes of a sum: ``sqrt(max(s, 1e-30))``, ``max(s,
    1e-12)`` and ``s > 0``."""
    rng = np.random.default_rng(width)
    for n in range(1, width + 1):
        signs = rng.random((64, n)) < 0.5
        rows = torch.tensor(np.where(signs, -0.0, 0.0), dtype=dtype)
        rows[0] = -0.0
        got = group_butterfly(rows, width)[..., 0]
        want = cone_kernels._warp_sum(rows)
        assert bool((got == 0).all()) and bool((want == 0).all())
        for use in (lambda s: torch.sqrt(torch.clamp(s, min=1e-30)),
                    lambda s: torch.clamp(s, min=1e-12)):
            assert torch.equal(use(got), use(want))
        assert torch.equal(got > 0, want > 0)
    # The one difference: G negative zeros keep their sign on G lanes, and
    # lose it to the padding's positive zeros on 32 when G < 32.
    full = -torch.zeros(1, width, dtype=dtype)
    assert bool(torch.signbit(group_butterfly(full, width)[0, 0]))
    assert bool(torch.signbit(cone_kernels._warp_sum(full)[0])) == (
        width == 32)


@pytest.mark.parametrize("k", [1, 2, 4, 5, 9, 10])
def test_plain_apgd_on_groups_gives_the_same_bits(k, monkeypatch):
    """``plain_apgd`` with its sums taken by the kernel's group of
    ``kGroupLanes`` lanes in place of 32 gives the plain version's bits on
    random PSD problems (``chip_smoke.random_psd_qps``'s recipe) in both
    types, and on problems whose iterates stay near zero (q = 0)."""
    rng = np.random.default_rng(40 + k)
    n = 3 * k
    A = rng.standard_normal((32, n, n))
    Q = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(n)
    q = 2.0 * rng.standard_normal((32, n))
    q[:4] = 0.0
    width = group_lanes(n)
    for dtype in (torch.float32, torch.float64):
        Qt, qt = (torch.tensor(a, dtype=dtype) for a in (Q, q))
        want = cone_kernels.plain_apgd(Qt, qt, 60)
        with monkeypatch.context() as patch:
            patch.setattr(cone_kernels, "_warp_sum",
                          lambda v: group_butterfly(v, width)[..., 0])
            got = cone_kernels.plain_apgd(Qt, qt, 60)
        assert torch.equal(got, want), (k, dtype)
        assert want[:4].abs().max() < 1e-6 and want.abs().max() > 0.1


def test_wrapper_routes():
    """``solve_cone_qp_cuda`` on CPU tensors is ``plain_apgd`` and counts
    no launch; the check of a CUDA call takes k = 11 cones (any k builds
    at first use) and refuses none, and tensors on two devices or on
    another device raise."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((8, 12, 12))
    Q = torch.tensor(A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(12))
    q = torch.tensor(rng.standard_normal((8, 12)))
    before = cone_kernels.solve_cone_qp_cuda.launches
    assert torch.equal(cone_kernels.solve_cone_qp_cuda(Q, q, 40),
                       cone_kernels.plain_apgd(Q, q, 40))
    assert cone_kernels.solve_cone_qp_cuda.launches == before
    assert cone_kernels._check(torch.zeros(2, 33, 33),
                               torch.zeros(2, 33)) == (2, 11)
    with pytest.raises(ValueError, match="k = 0"):
        cone_kernels._check(torch.zeros(2, 0, 0), torch.zeros(2, 0))
    with pytest.raises(ValueError, match="several devices"):
        cone_kernels.solve_cone_qp_cuda(Q, q.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cone_kernels.solve_cone_qp_cuda(Q.to("meta"), q.to("meta"))
