"""The port's StencilMat and kernel K1's plain version against petsctpu's,
on the CPU.

* K1's plain version (`stencil_mult` on CPU tensors) against the Pallas
  kernel `stencil5_mult_pallas` in interpret mode, at the shapes of
  tests/test_pallas_ops.py (8×128 and 32×128 tiled, 7×100 through its
  jnp fallback), atol 1e-12: the two sum the same five products in
  another order.
* StencilMat.mult/multT/diagonal/rows_sum/shift_diag against
  petsctpu.mat.stencil for 2-D 5-point, 3-D 7-point, 3-D 27-point,
  periodic and mirror stencils, rtol 1e-13 (atol 1e-13·max|y| for
  entries that cancel to rounding noise).
* stencil_from_scipy/stencil_to_scipy round trips equal to the
  reference's, exactly (they copy values).
* galerkin_coarsen's planes against the reference's and against scipy
  PᵀAP within 1e-13 (as tests/test_mg.py:120-161 does).
All fp64; inputs from numpy generators with fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.dm import DA as JDA
from petsctpu.mat import stencil as jst
from petsctpu.models import laplacian_2d as jlaplacian_2d
from petsctpu.ops.stencil_pallas import stencil5_mult_pallas
from petsctpu_torch.dm import DA
from petsctpu_torch.mat import stencil as tst
from petsctpu_torch.models import laplacian_2d, poisson_3d
from petsctpu_torch.ops.stencil_mult import stencil_mult, stencil_mult_plain

CPU = "cpu"
STAR5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
STAR7 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
         (0, 0, -1), (0, 0, 1))
BOX27 = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
              for k in (-1, 0, 1))
CASES = {
    "2d_star5": ((7, 9), STAR5, ()),
    "3d_star7": ((4, 5, 3), STAR7, ()),
    "3d_box27": ((5, 4, 6), BOX27, ()),
    "periodic": ((6, 8), STAR5 + ((2, -1), (-1, 3)), ("periodic", "none")),
    "mirror": ((5, 6), STAR5 + ((2, 0), (0, -2)), ("mirror", "none")),
    "mixed_3d": ((2, 6, 5), STAR7 + ((2, 1, 0),),
                 ("mirror", "periodic", "none")),
}


def _pair(name, seed=0):
    grid, offs, bnd = CASES[name]
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((len(offs),) + grid)
    x = rng.standard_normal(int(np.prod(grid)))
    return (tst.StencilMat(torch.from_numpy(C), offs, grid, bnd),
            jst.StencilMat(jnp.asarray(C), offs, grid, bnd), x)


def _close(got, ref, rtol=1e-13):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("m,n", [(8, 128), (32, 128), (7, 100)])
def test_plain_k1_matches_pallas_interpret(m, n):
    rng = np.random.default_rng(0)
    C = rng.standard_normal((5, m, n))
    x = rng.standard_normal((m, n))
    ref = np.asarray(stencil5_mult_pallas(jnp.asarray(C), jnp.asarray(x),
                                          interpret=True))
    got = stencil_mult(torch.from_numpy(C), torch.from_numpy(x), STAR5,
                       (m, n))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("method", ["mult", "multT", "diagonal",
                                    "rows_sum", "shift_diag"])
def test_stencilmat_matches_petsctpu(name, method):
    S, J, x = _pair(name)
    if method == "mult":
        _close(S.mult(torch.from_numpy(x)), J.mult(jnp.asarray(x)))
        # shape-preserving: a grid-shaped operand gives a grid-shaped y
        yg = S.mult(torch.from_numpy(x).reshape(S.grid))
        assert tuple(yg.shape) == S.grid
        _close(yg.reshape(-1), J.mult(jnp.asarray(x)))
    elif method == "multT":
        if "mirror" in S.boundary:
            for M in (S, J):
                with pytest.raises(NotImplementedError, match="mirror"):
                    M.multT(x if M is J else torch.from_numpy(x))
            return
        _close(S.multT(torch.from_numpy(x)), J.multT(jnp.asarray(x)))
    elif method == "diagonal":
        _close(S.diagonal(), J.diagonal())
    elif method == "rows_sum":
        _close(S.rows_sum(), J.rows_sum())
    else:
        S2, J2 = S.shift_diag(0.75), J.shift_diag(0.75)
        _close(S2.coeffs, J2.coeffs)
        _close(S2.mult(torch.from_numpy(x)), J2.mult(jnp.asarray(x)))
        _close(S.scale(-2.5).mult(torch.from_numpy(x)),
               J.scale(-2.5).mult(jnp.asarray(x)))
        assert S.flops_per_mult() == J.flops_per_mult()
        assert S.nnz == J.nnz and S.shape == J.shape


def test_mult_against_scipy_and_multT_against_transpose():
    """The assembled operator agrees with both products (none and
    periodic axes; stencil_to_scipy folds periodic wraps in)."""
    for name in ("2d_star5", "3d_box27", "periodic"):
        S, _, x = _pair(name, seed=4)
        A = tst.stencil_to_scipy(S)
        _close(S.mult(torch.from_numpy(x)), A @ x, rtol=1e-12)
        _close(S.multT(torch.from_numpy(x)), A.T @ x, rtol=1e-12)


def test_shift_diag_without_diagonal_raises():
    S = tst.StencilMat(torch.ones((2, 3, 3), dtype=torch.float64),
                       ((1, 0), (0, 1)), (3, 3))
    with pytest.raises(ValueError, match="no diagonal"):
        S.shift_diag(1.0)
    assert torch.equal(S.diagonal(), torch.zeros(9, dtype=torch.float64))


@pytest.mark.parametrize("which", ["lap2d", "poisson3d", "variable",
                                   "given_offsets"])
def test_stencil_from_scipy_round_trip_matches_petsctpu(which):
    rng = np.random.default_rng(7)
    offsets = None
    if which == "lap2d":
        A, grid = laplacian_2d(7, 9), (7, 9)
    elif which == "poisson3d":
        A, grid = poisson_3d(4, 5, 3), (3, 5, 4)
    else:
        A, grid = laplacian_2d(6, 6), (6, 6)
        A = A.tocoo()
        A = sp.csr_matrix((A.data * (1 + 0.3 * rng.standard_normal(A.nnz)),
                           (A.row, A.col)), shape=A.shape)
        if which == "given_offsets":
            offsets = DA(grid, stencil_type="box").stencil_offsets()
    S = tst.stencil_from_scipy(A, grid, offsets=offsets, device=CPU)
    J = jst.stencil_from_scipy(A, grid, offsets=offsets)
    assert S.offsets == J.offsets and S.grid == J.grid
    assert S.boundary == J.boundary == ()
    np.testing.assert_array_equal(S.coeffs.numpy(), np.asarray(J.coeffs))
    back = tst.stencil_to_scipy(S)
    assert abs(back - jst.stencil_to_scipy(J)).max() == 0.0
    assert abs(back - A).max() == 0.0
    S32 = tst.stencil_from_scipy(A, grid, dtype=np.float32, device=CPU)
    assert S32.dtype == torch.float32
    np.testing.assert_array_equal(
        S32.coeffs.numpy(),
        np.asarray(jst.stencil_from_scipy(A, grid, dtype=np.float32).coeffs))


def test_stencil_to_scipy_periodic_matches_petsctpu():
    S, J, _ = _pair("periodic", seed=3)
    assert abs(tst.stencil_to_scipy(S) - jst.stencil_to_scipy(J)).max() == 0


def test_unflatten_and_coarse_reach_match_petsctpu():
    grid = (5, 7, 9)
    strides = np.array([63, 9, 1])
    for f in (-72, -64, -63, -10, -9, -8, -1, 0, 1, 8, 9, 10, 63, 64, 72):
        assert tst._unflatten_offset(f, grid, strides) == \
            jst._unflatten_offset(f, grid, strides)
    for name in CASES:
        S, J, _ = _pair(name)
        assert tst.coarse_reach(S) == jst.coarse_reach(J)


def _box9(rng, m=17):
    offs = DA((m, m), stencil_type="box").stencil_offsets()
    idx = np.arange(m * m)
    i, j = idx // m, idx % m
    rows, cols, vals = [], [], []
    for (oi, oj) in offs:
        ok = (i + oi >= 0) & (i + oi < m) & (j + oj >= 0) & (j + oj < m)
        rows.append(idx[ok])
        cols.append(idx[ok] + oi * m + oj)
        base = 8.0 if (oi, oj) == (0, 0) else -1.0
        vals.append(base + 0.1 * rng.standard_normal(ok.sum()))
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(m * m, m * m)).tocsr()
    return A, offs


@pytest.mark.parametrize("which", ["lap2d_33", "poisson3d_9", "box9_17"])
def test_galerkin_coarsen_matches_petsctpu_and_scipy(which):
    offsets = None
    if which == "lap2d_33":
        grid, A = (33, 33), jlaplacian_2d(33, 33)
    elif which == "poisson3d_9":
        grid, A = (9, 9, 9), poisson_3d(9, 9, 9)
    else:
        grid = (17, 17)
        A, offsets = _box9(np.random.default_rng(3))
    da, jda = DA(grid), JDA(grid)
    co = da.coarsen()
    Ac = tst.galerkin_coarsen(
        tst.stencil_from_scipy(A, grid, offsets=offsets, device=CPU),
        da.interpolation(co), co.grid)
    Jc = jst.galerkin_coarsen(jst.stencil_from_scipy(A, grid, offsets=offsets),
                              jda.interpolation(jda.coarsen()), co.grid)
    assert Ac.offsets == Jc.offsets and Ac.grid == Jc.grid == co.grid
    ref = np.asarray(Jc.coeffs)
    np.testing.assert_allclose(Ac.coeffs.numpy(), ref, rtol=1e-13,
                               atol=1e-13 * np.abs(ref).max())
    from petsctpu_torch.dm import q1_interp_scipy
    Ps = q1_interp_scipy(grid, co.grid)
    assert abs((Ps.T @ A @ Ps).tocsr() - tst.stencil_to_scipy(Ac)).max() \
        < 1e-13


def test_galerkin_coarsen_rejects_periodic():
    S, _, _ = _pair("periodic")
    with pytest.raises(NotImplementedError, match="periodic"):
        tst.galerkin_coarsen(S, None, (3, 4))


def test_plain_k1_sums_in_offset_order():
    """stencil_mult_plain is the kernel's arithmetic: products rounded,
    then added in offset order from 0, which a numpy loop repeats bit
    for bit."""
    S, _, x = _pair("mirror", seed=9)
    grid, offs, bnd = CASES["mirror"]
    C = S.coeffs.numpy()
    xg = x.reshape(grid)
    ref = np.zeros(grid)
    for d, (oi, oj) in enumerate(offs):
        ii = np.arange(grid[0])[:, None] + oi
        ii = np.where(ii < 0, -ii, np.where(ii >= grid[0],
                                            2 * (grid[0] - 1) - ii, ii))
        jj = np.arange(grid[1])[None, :] + oj
        ok = (jj >= 0) & (jj < grid[1])
        nb = np.where(ok, xg[ii, np.clip(jj, 0, grid[1] - 1)], 0.0)
        ref = ref + C[d] * nb
    got = stencil_mult_plain(S.coeffs, torch.from_numpy(x), offs, grid, bnd)
    np.testing.assert_array_equal(got.numpy(), ref.reshape(-1))


def test_stencil_mult_rejects_what_the_kernel_does_not_take():
    C = torch.zeros((5, 4, 6), dtype=torch.float64)
    x = torch.zeros(24, dtype=torch.float64)
    assert stencil_mult(C, x, STAR5, (4, 6)).shape == (24,)
    with pytest.raises(ValueError, match="not supported"):
        stencil_mult(C.to("meta"), x.to("meta"), STAR5, (4, 6))
    bad = [dict(x=x.float()),
           dict(C=C.to(torch.int32), x=x.to(torch.int32)),
           dict(C=C[:4]),
           dict(x=torch.zeros(25, dtype=torch.float64)),
           dict(x=torch.zeros(48, dtype=torch.float64)[::2]),
           dict(offsets=STAR5[:4] + ((0, 1, 0),)),
           dict(boundary=("reflect", "none")),
           dict(grid=(2, 2, 2, 3), C=C.reshape(5, 2, 2, 2, 3))]
    for over in bad:
        a = dict(C=C, x=x, offsets=STAR5, grid=(4, 6), boundary=())
        a.update(over)
        with pytest.raises(ValueError):
            stencil_mult(a["C"], a["x"], a["offsets"], a["grid"],
                         a["boundary"])
