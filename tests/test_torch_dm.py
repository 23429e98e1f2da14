"""The port's DA and Q1 transfers against petsctpu.dm.da, on the CPU.

Stencil offsets, the coarsen/refine/can_coarsen rules, create_matrix,
local_with_ghosts on every boundary type, Q1Interp.mult/multT and the
scipy interpolation twins (Q1 with none and periodic axes, Q0, MAIJ),
all fp64 from seeded numpy inputs, held to the reference within 1e-14
(Q1 sums at most three terms, so the two agree to a few ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petsctpu.dm import da as jda
from petsctpu_torch.dm import da as tda

CPU = "cpu"
GRIDS = [(9,), (9, 7), (5, 7, 9), (33, 33)]


def _close(got, ref, tol=1e-14):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("grid", [(4, 4), (3, 5, 4), (6,)])
@pytest.mark.parametrize("stencil_type", ["star", "box"])
@pytest.mark.parametrize("width", [1, 2])
def test_stencil_offsets_match(grid, stencil_type, width):
    T = tda.DA(grid, width, stencil_type)
    J = jda.DA(grid, width, stencil_type)
    assert T.stencil_offsets() == J.stencil_offsets()
    assert T.stencil_offsets()[0] == (0,) * len(grid)
    assert T.n == J.n and T.ndim == J.ndim


@pytest.mark.parametrize("grid,boundary", [
    ((33, 33), ()), ((9, 9, 9), ()), ((8, 9), ("periodic", "none")),
    ((16,), "periodic"), ((5, 3), ()), ((4, 9), ()), ((3, 3), ())])
def test_hierarchy_rules_match(grid, boundary):
    T, J = tda.DA(grid, boundary=boundary), jda.DA(grid, boundary=boundary)
    assert T.boundary_types() == J.boundary_types()
    assert T.can_coarsen() == J.can_coarsen()
    assert T.refine().grid == J.refine().grid
    try:
        jc = J.coarsen().grid
    except ValueError:
        with pytest.raises(ValueError):
            T.coarsen()
        return
    assert T.coarsen().grid == jc
    assert T.coarsen().boundary == J.coarsen().boundary


def test_ex45_hierarchy_129():
    """The ex45 main path's chain: 129³ down to a 3³ coarse grid."""
    da, grids = tda.DA((129, 129, 129)), []
    while da.can_coarsen() and da.n > 65:
        grids.append(da.grid[0])
        da = da.coarsen()
    assert grids + [da.grid[0]] == [129, 65, 33, 17, 9, 5, 3]


@pytest.mark.parametrize("grid,kw", [
    ((5, 5), {}), ((3, 4, 5), {"stencil_type": "box"}),
    ((6, 4), {"boundary": ("periodic", "none")}),
    ((4, 4), {"boundary": ("mirror", "mirror")})])
def test_create_matrix_matches(grid, kw):
    T = tda.DA(grid, **kw).create_matrix(device=CPU)
    J = jda.DA(grid, **kw).create_matrix()
    assert T.shape == J.shape and T.offsets == J.offsets
    assert T.boundary == J.boundary and T.grid == J.grid
    assert T.dtype == torch.float64 and T.device.type == "cpu"
    assert not T.coeffs.any()
    T32 = tda.DA(grid, **kw).create_matrix(torch.float32, device=CPU)
    assert T32.dtype == torch.float32
    v = tda.DA(grid, **kw).create_global_vector(device=CPU)
    assert v.shape == (T.shape[0],) and v.dtype == torch.float64


@pytest.mark.parametrize("grid,boundary,width", [
    ((4, 4), (), 1), ((4, 5), "ghosted", 2),
    ((5, 6), ("periodic", "none"), 1), ((5, 6), ("mirror", "periodic"), 2),
    ((3, 4, 5), ("mirror", "ghosted", "periodic"), 1), ((7,), "mirror", 3)])
def test_local_with_ghosts_matches(grid, boundary, width):
    x = np.random.default_rng(2).standard_normal(int(np.prod(grid)))
    for fill in (0.0, -1.5):
        T = tda.DA(grid, width, boundary=boundary)
        J = jda.DA(grid, width, boundary=boundary)
        got = T.local_with_ghosts(torch.from_numpy(x), fill=fill)
        ref = J.local_with_ghosts(jnp.asarray(x), fill=fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        T.from_grid(T.to_grid(torch.from_numpy(x))).numpy(), x)


@pytest.mark.parametrize("fine", [(9,), (9, 7), (5, 7, 9), (33, 33)])
def test_q1interp_matches(fine):
    coarse = tuple((g + 1) // 2 for g in fine)
    T = tda.DA(fine).interpolation(tda.DA(coarse))
    J = jda.Q1Interp(fine, coarse)
    assert T.shape == J.shape
    rng = np.random.default_rng(1)
    xc = rng.standard_normal(T.shape[1])
    xf = rng.standard_normal(T.shape[0])
    _close(T.mult(torch.from_numpy(xc)), J.mult(jnp.asarray(xc)))
    _close(T.multT(torch.from_numpy(xf)), J.multT(jnp.asarray(xf)))
    Ps = tda.q1_interp_scipy(fine, coarse)
    _close(T.mult(torch.from_numpy(xc)), Ps @ xc)
    _close(T.multT(torch.from_numpy(xf)), Ps.T @ xf)


def test_interpolation_rejects_wrong_coarse_grid():
    with pytest.raises(ValueError, match="not the coarsening"):
        tda.DA((9, 9)).interpolation(tda.DA((4, 5)))


@pytest.mark.parametrize("fine,coarse,boundary", [
    ((9, 7), (5, 4), ()), ((5, 7, 9), (3, 4, 5), ()),
    ((8, 9), (4, 5), ("periodic", "none")), ((12,), (6,), "periodic")])
def test_scipy_interpolations_match(fine, coarse, boundary):
    got = tda.q1_interp_scipy(fine, coarse, boundary)
    ref = jda.q1_interp_scipy(fine, coarse, boundary)
    assert got.shape == ref.shape and abs(got - ref).max() == 0.0
    T = tda.DA(fine, boundary=boundary)
    J = jda.DA(fine, boundary=boundary)
    assert abs(T.interpolation_scipy(tda.DA(coarse, boundary=boundary))
               - J.interpolation_scipy(jda.DA(coarse, boundary=boundary))
               ).max() == 0.0
    for dof in (1, 3):
        assert abs(tda.interp_dof_scipy(got, dof)
                   - jda.interp_dof_scipy(ref, dof)).max() == 0.0


@pytest.mark.parametrize("fine,coarse", [((8, 6), (4, 3)), ((4, 6, 2), (2, 3, 1)),
                                         ((6,), (6,))])
def test_q0_interp_matches(fine, coarse):
    got = tda.q0_interp_scipy(fine, coarse)
    ref = jda.q0_interp_scipy(fine, coarse)
    assert got.shape == ref.shape and abs(got - ref).max() == 0.0
    with pytest.raises(ValueError):
        tda.q0_interp_scipy(fine, tuple(2 * c + 1 for c in coarse))


def test_coordinates_and_vectors_match():
    T, J = tda.DA((5, 3, 4)), jda.DA((5, 3, 4))
    for a, b in zip(T.coordinates(-1.0, 2.0), J.coordinates(-1.0, 2.0)):
        np.testing.assert_array_equal(a, b)


def test_entry_points_build_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    da = tda.DA((4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        da.create_global_vector()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        da.create_matrix()
